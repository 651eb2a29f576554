"""videowalk_tpu_torch — the PyTorch/CUDA port of ``videowalk_tpu``.

The JAX package ``videowalk_tpu`` is the reference; this package mirrors its
module layout so each counterpart is easy to find, and it imports neither
``jax`` nor anything of ``videowalk_tpu``. Plain tensor code is PyTorch;
every Pallas TPU kernel on a ported path is a CUDA C++ kernel for Hopper
(``sm_90a``) under ``ops/csrc/``, built at first use (``ops/_build.py``).

Ported so far: the label-propagation eval path
(``python -m videowalk_tpu_torch.cli.test`` on DAVIS, JHMDB and VIP, with
DAVIS J&F, PCK and mIoU and the sweep runner) and CRW training in patch,
superpixel and teacher-student mode, from the step
(``parallel.make_train_step``) up to the trainer
(``python -m videowalk_tpu_torch.cli.train``) and its data layer:

utils     device resolution, checkpoints (.pth loading and writing,
          flax-tree import, full-state resume), argument parsers, train
          meters, colors, the PCA feature images
core      walk-loss math: affinities, ZeroSoftmax, palindrome products,
          Sinkhorn-Knopp and the sk-targets loss, superpixel masks
models    ResNet-18 trunk (flax-semantics BN, bf16 compute, reflect convs
          routed to the reflect-conv kernels with BN moments fused),
          encoder factory, CRW (patch, superpixel and whole-frame nodes,
          walk loss), teacher-student CRW
ops       CUDA kernels + their plain PyTorch versions: block-sparse top-k
          propagation, fused palindrome walk (forward and backward),
          3x3 reflect conv (forward, + BN moments, the BN-input chain,
          dx, dW) and its route, SLIC, L1 dilation; batched device
          augmentations (plain PyTorch)
parallel  optimizer, train state, train step
eval      context bank + autoregressive propagation, prediction dumping
          and pose keypoints; DAVIS palette conversion, J&F, JHMDB PCK,
          VIP mIoU (numpy array cores, file shells), the sweep runner
data      Kinetics clip index and dataset, frame-folder datasets, host
          augmentations, threaded loader, prefetch to the card; DAVIS-style
          VOS dataset (texture, LAB), JHMDB pose dataset
cli       the ``train`` and ``test`` entry points
"""
