"""videowalk_tpu_torch — the PyTorch/CUDA port of ``videowalk_tpu``.

The JAX package ``videowalk_tpu`` is the reference; this package mirrors its
module layout so each counterpart is easy to find, and it imports neither
``jax`` nor anything of ``videowalk_tpu``. Plain tensor code is PyTorch;
every Pallas TPU kernel on a ported path is a CUDA C++ kernel for Hopper
(``sm_90a``) under ``ops/csrc/``, built at first use (``ops/_build.py``).

Ported so far: the DAVIS label-propagation eval path
(``python -m videowalk_tpu_torch.cli.test``) and the patch-mode CRW
training step (``parallel.make_train_step``):

utils     device resolution, checkpoint (.pth / flax-tree) loading, colors
core      walk-loss math: affinities, ZeroSoftmax, palindrome products
models    ResNet-18 trunk (flax-semantics BN, bf16 compute, reflect convs
          routed to the reflect-conv kernels with BN moments fused),
          encoder factory, CRW (patch and whole-frame nodes, walk loss)
ops       CUDA kernels + their plain PyTorch versions: block-sparse top-k
          propagation, fused palindrome walk (forward and backward),
          3x3 reflect conv (forward, + BN moments, dx, dW) and its route
parallel  optimizer, train state, train step
eval      context bank + autoregressive propagation, prediction dumping
data      DAVIS-style VOS dataset
cli       the ``test`` entry point
"""
