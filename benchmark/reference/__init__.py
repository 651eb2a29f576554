"""The benchmark's plain references: f32 PyTorch, TF32 off, written from the
published equations of the contrastive random walk (Jabri et al., 2020) and
of the thesis fork's superpixel nodes. They import nothing of the program
under test (``videowalk_tpu_torch``) nor of the JAX package, and take only
what the benchmark made: the seeded weights and the inputs."""
