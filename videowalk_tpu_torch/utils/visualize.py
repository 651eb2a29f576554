"""Training visualization and experiment logging (counterpart of
``videowalk_tpu/utils/visualize.py``; reference ``code/utils/visualize.py``).

- ``Visualize``      <-> :97-127 (wandb when importable, else JSON lines
  under ``logs_dir``)
- ``pca_feats``      <-> :22-44 (PCA of feature maps to RGB; numpy SVD in
  place of sklearn; the eval CLI's ``--pca-vis``)
- ``make_gif``       <-> :46-60
- ``draw_matches``   <-> :63-94
- ``compute_flow``   <-> :164-183 (argmax-correspondence flow field)
- ``vis_flow_plt``   <-> :185-205 (quiver plot)
- ``frame_pair``     <-> :208-286 (walk diagnostics panel)
- ``nn_patches``     <-> :134-160 (patch nearest-neighbour browser)
- ``vis_adj``        <-> :296-345 (superpixel boundaries + adjacency maps,
  without the reference's live ``breakpoint()`` at :342)

They take numpy arrays or CPU tensors. wandb, cv2, matplotlib and imageio
are imported inside the functions that need them (the card's machine has
none of them); figures are saved as PNGs under ``logs_dir``.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


def _wandb():
    """wandb where it is installed, else None (imported at first use)."""
    try:
        import wandb
    except ImportError:
        return None
    return wandb


def _require_cv2(what: str):
    """cv2, or a RuntimeError naming the helper that needs it."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(f"{what} requires opencv-python (cv2), which "
                           f"failed to import in this environment") from e
    return cv2


def _normalize01(x: np.ndarray) -> np.ndarray:
    """Min-max to [0, 1] with a 1e-12 floor."""
    x = np.asarray(x)
    lo = x.min()
    return (x - lo) / max(x.max() - lo, 1e-12)


def pca_feats(ff: np.ndarray, K: int = 1, whiten: bool = True,
              img_normalize: bool = True):
    """PCA feature maps -> RGB images (reference :22-44).

    Args:
      ff: (N, C, H, W) features.
    Returns:
      (N, 3, H, W) in [0, 1] (or a list of K such arrays).
    """
    ff = np.asarray(ff, np.float64)
    N, C, H, W = ff.shape
    X = ff.transpose(0, 2, 3, 1).reshape(-1, C)
    X = X - X.mean(0, keepdims=True)
    U, S, Vt = np.linalg.svd(X, full_matrices=False)
    comps = U[:, :3 * K] * (np.sqrt(X.shape[0] - 1) if whiten
                            else S[:3 * K][None])
    pca_ff = comps.reshape(N, H, W, 3 * K).transpose(0, 3, 1, 2)
    outs = [pca_ff[:, kk:kk + 3] for kk in range(0, 3 * K, 3)]
    if img_normalize:
        outs = [_normalize01(x) for x in outs]
    return outs[0] if K == 1 else outs


def make_gif(video: np.ndarray, outname: str | None = "/tmp/test.gif",
             sz: int = 256):
    """(N, 3, H, W) or (N, H, W, 3), float [0, 1] or uint8 -> resized
    gif, or the resized stack when ``outname`` is None (reference
    :46-60). A channel-first uint8 video keeps its values; floats are
    clipped before the uint8 cast."""
    cv2 = _require_cv2("make_gif")
    video = np.asarray(video)
    if video.ndim == 4 and video.shape[1] == 3 and video.shape[-1] != 3:
        video = video.transpose(0, 2, 3, 1)
    if video.dtype != np.uint8:
        video = (np.clip(video, 0.0, 1.0) * 255).astype(np.uint8)
    video = [cv2.resize(v, (sz, sz)) for v in video]
    if outname is None:
        return np.stack(video)
    import imageio

    imageio.mimsave(outname, video, duration=0.2)
    return None


def make_grid(imgs: np.ndarray, nrow: int, padding: int = 1,
              pad_value: float = 1.0) -> np.ndarray:
    """(N, C, H, W) -> (C, H', W') tiled grid (torchvision-free)."""
    imgs = np.asarray(imgs)
    N, C, H, W = imgs.shape
    ncol = nrow
    nrows = -(-N // ncol)
    out = np.full((C, nrows * (H + padding) + padding,
                   ncol * (W + padding) + padding), pad_value, imgs.dtype)
    for i in range(N):
        r, c = divmod(i, ncol)
        y, x = padding + r * (H + padding), padding + c * (W + padding)
        out[:, y:y + H, x:x + W] = imgs[i]
    return out


def draw_matches(x1, x2, i1, i2):
    """Brute-force keypoint correspondence drawing (reference :63-94):
    match feature columns of two frames with cv2.BFMatcher and render the
    matches over the resized frames. x1/x2: (C, N) features; i1/i2:
    (3, H, W) images in [0, 1]."""
    cv2 = _require_cv2("draw_matches")

    def detach(x):
        return np.asarray(x).transpose(1, 2, 0) * 255

    i1, i2 = detach(i1), detach(i2)
    i1 = cv2.resize(i1, (400, 400))
    i2 = cv2.resize(i2, (400, 400))

    bf = cv2.BFMatcher(cv2.NORM_L2, crossCheck=True)
    h = int(np.asarray(x1).shape[-1] ** 0.5)
    matches = bf.match(np.asarray(x1).T.astype(np.float32),
                       np.asarray(x2).T.astype(np.float32))
    scale = i1.shape[-2] / h
    gx, gy = np.meshgrid(np.arange(h), np.arange(h))
    grid = np.stack([gx.ravel(), gy.ravel()]) * scale + scale // 2
    kps = [cv2.KeyPoint(float(grid[0][i]), float(grid[1][i]), 1)
           for i in range(grid.shape[-1])]
    matches = sorted(matches, key=lambda m: m.distance)
    out = cv2.drawMatches(i1.astype(np.uint8), kps, i2.astype(np.uint8),
                          kps, matches, None, flags=2)
    return out.transpose(2, 0, 1)


def compute_flow(corr: np.ndarray):
    """Argmax-correspondence flow from an affinity map
    (reference :164-183). corr: (N, HW, HW)."""
    corr = np.asarray(corr)
    h = w = int(corr.shape[-1] ** 0.5)
    corr = np.swapaxes(corr, -1, -2).reshape(*corr.shape[:-1], h, w)
    nnf = corr.argmax(axis=1)
    u = (nnf % w).astype(np.int64)
    v = (nnf // h).astype(np.int64)
    rr = np.arange(u.shape[-1])[None]
    for i in range(u.shape[-1]):
        u[:, i] -= rr[0]
    for i in range(v.shape[-1]):
        v[:, :, i] -= rr[0]
    return u, v


def vis_flow_plt(u, v, x1, x2, A):
    """Quiver plot of the flow field over the frame (reference :185-205).
    The anchors are ``k * Ih / (H + 1)``, k = 1..H, exactly: the
    reference's float-step ``mgrid`` gives H + 2 rows for some sizes."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import cm

    flows = np.stack([u, v], axis=-1)[0]
    I = np.asarray(x1)
    A = np.asarray(A)
    H, W = flows.shape[:2]
    Ih, Iw = I.shape[-2:]
    ys = np.linspace(0, Ih, H + 2)[1:-1]
    xs = np.linspace(0, Iw, W + 2)[1:-1]
    mx, my = np.meshgrid(ys, xs, indexing="ij")

    fig, ax = plt.subplots()
    ax.imshow(I.transpose(1, 2, 0))
    ent = (A * np.log(np.clip(A, 1e-20, None))).sum(-1)
    Cc = cm.jet(_normalize01(ent))
    ax.quiver(my, mx, flows[..., 0], flows[..., 1] * -1,
              color=Cc.reshape(-1, 4))
    return fig


class Visualize:
    """Experiment logger (reference :97-127): wandb when importable, else
    JSON lines appended to ``<logs_dir>/metrics.jsonl``."""

    def __init__(self, args):
        self._env_name = getattr(args, "name", "videowalk_tpu")
        self.args = args
        self._init = False
        self._wandb = None
        self._jsonl = None
        self.vis = None  # visdom handle in the reference; kept for API parity

    def _logs_dir(self) -> str:
        logs_dir = getattr(self.args, "logs_dir", ".") or "."
        os.makedirs(logs_dir, exist_ok=True)
        return logs_dir

    def _open_jsonl(self):
        self._jsonl = open(os.path.join(self._logs_dir(),
                                        "metrics.jsonl"), "a")

    def wandb_init(self, model=None):
        if self._init:
            return
        self._init = True
        wandb = _wandb()
        if wandb is None:
            self._open_jsonl()
            return
        # a failed init (no API key, offline host) must neither end the
        # run nor drop metrics: log to JSON lines instead
        try:
            wandb.init(project="dilated-superpixels", group="main",
                       config=vars(self.args)
                       if hasattr(self.args, "__dict__") else {})
            self._wandb = wandb
        except Exception as e:  # noqa: BLE001 - any wandb failure
            print(f"WARNING: wandb.init failed ({e}); logging to "
                  f"metrics.jsonl instead", flush=True)
            self._open_jsonl()

    def log(self, key_vals: dict):
        if not self._init:
            self.wandb_init()
        if self._wandb is not None and self._wandb.run is not None:
            self._wandb.log(key_vals)
        elif self._jsonl is not None:
            rec = {"t": time.time()}
            for k, v in key_vals.items():
                # as wandb takes any scalar: a non-numeric value is kept as
                # its string
                try:
                    rec[k] = float(v)
                except (TypeError, ValueError):
                    rec[k] = str(v)
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None

    def save_figure(self, fig, name: str):
        path = os.path.join(self._logs_dir(), f"{name}.png")
        fig.savefig(path)
        import matplotlib.pyplot as plt

        plt.close(fig)
        return path

    def save_image(self, img: np.ndarray, name: str):
        """img: (C, H, W) or (H, W, C) float [0, 1]."""
        cv2 = _require_cv2("Visualize.save_image")
        img = np.asarray(img)
        if img.ndim == 3 and img.shape[0] in (1, 3):
            img = img.transpose(1, 2, 0)
        path = os.path.join(self._logs_dir(), f"{name}.png")
        cv2.imwrite(path,
                    (np.clip(img, 0, 1) * 255).astype(np.uint8)[..., ::-1])
        return path

    def nn_patches(self, P, A_k, prefix="", N=10, K=20):
        nn_patches(self, P, A_k, prefix, N, K)


def nn_patches(vis: Visualize, P, A_k, prefix="", N=10, K=20):
    """Nearest-neighbour patch browser (reference :134-160): for N random
    query patches, tile the top-K neighbours by affinity; saved as PNG
    grids."""
    P = _normalize01(np.asarray(P, np.float64))
    A_k = np.asarray(A_k)
    I = np.argsort(-A_k, axis=-1)
    rng = np.random.RandomState(0)
    for n, i in enumerate(rng.permutation(P.shape[0])[:N]):
        for k in range(I.shape[0]):
            grid = make_grid(P[I[k, i, :K]], nrow=min(I.shape[-1], 20))
            vis.save_image(grid, f"{prefix}_patch_values_{n}_{k}")


def frame_pair(x, ff, mm, t1, t2, A, AA, xent_loss, vis: Visualize):
    """Walk diagnostics for a frame pair (reference :208-286): PCA of the
    embeddings, the flow quiver and the per-node loss-coloured walk maps,
    saved as PNGs through ``vis``. ``ff`` is taken for the reference's
    signature and not read."""
    del ff
    x, mm = np.asarray(x), np.asarray(mm)
    A, AA = np.asarray(A), np.asarray(AA)
    xent_loss = np.asarray(xent_loss)

    N = AA.shape[-1]
    H = W = int(N ** 0.5)
    if H * W == N and x.ndim < 6:
        # whole-image input: PCA + flow panel
        x1 = _normalize01(x[0, t1].transpose(2, 0, 1))  # (3, H, W) from NTHWC
        u, v = compute_flow(A[0:1])
        fig = vis_flow_plt(u, v, x1, None, A[0])
        vis.save_figure(fig, f"flow_quiver_{t1}_{t2}")
        maps = mm[0, [t1, t2]].transpose(0, 3, 1, 2)  # (2, C, H', W')
        pca = pca_feats(maps)
        vis.save_image(make_grid(pca, nrow=2), f"pcafeats_{t1}_{t2}")
    elif x.ndim == 6:
        # patch input: PCA grids of patch feature maps
        m1 = mm[0, t1].transpose(0, 3, 1, 2)
        m2 = mm[0, t2].transpose(0, 3, 1, 2)
        pca = pca_feats(np.concatenate([m1, m2]))
        n = m1.shape[0]
        vis.save_image(make_grid(pca[:n], nrow=int(np.ceil(n ** 0.5))),
                       f"pca_patches_{t1}")
        vis.save_image(make_grid(pca[n:], nrow=int(np.ceil(n ** 0.5))),
                       f"pca_patches_{t2}")

    if H * W == N:
        # loss-coloured walk maps (reference :261-286)
        cv2 = _require_cv2("frame_pair loss maps")
        import matplotlib

        cmap = matplotlib.colormaps["winter"]
        AAm = AA.reshape(-1, H * W, H, W)
        xx = _normalize01(xent_loss[:H * W])
        tiles = []
        for idx in range(H * W):
            aa = AAm[0, idx][..., None]
            tile = cv2.resize(aa, (50, 50),
                              interpolation=cv2.INTER_NEAREST)[None]
            tile = np.repeat(tile, 3, 0) * np.asarray(
                cmap(float(xx[idx])))[:3, None, None]
            tiles.append(tile / max(tile.max(), 1e-12))
        vis.save_image(make_grid(np.asarray(tiles), nrow=H),
                       f"lossvis_{t1}_{t2}")


def _mark_boundaries(img: np.ndarray, seg: np.ndarray,
                     color=(0.93, 1.0, 0.0)) -> np.ndarray:
    """skimage.segmentation.mark_boundaries substitute."""
    img = np.asarray(img).astype(np.float64)
    seg = np.asarray(seg)
    if img.max() > 1.5:
        img = img / 255.0
    b = np.zeros(seg.shape, bool)
    b[:-1] |= seg[:-1] != seg[1:]
    b[:, :-1] |= seg[:, :-1] != seg[:, 1:]
    out = img.copy()
    out[b] = color
    return out


def vis_adj(video, sp_mask, As, vis: Visualize, orig_unnorm):
    """Superpixel boundary + adjacency heatmap panel (reference :296-345).
    The frames are min-max scaled to uint8 as ``cv2.normalize`` does
    (``data/superpixels.py::_normalize_uint8``, no cv2 needed)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from videowalk_tpu_torch.data.superpixels import _normalize_uint8

    video = np.asarray(video)
    T = video.shape[0]
    fig, ax = plt.subplots(2, T, figsize=(4 * T, 8), squeeze=False)
    for t in range(T):
        img = np.asarray(orig_unnorm[t])
        if img.shape[0] == 3:
            img = img.transpose(1, 2, 0)
        img = _normalize_uint8(np.ascontiguousarray(img))
        seg = np.asarray(sp_mask[t])
        if seg.ndim == 3:
            seg = seg[0]
        ax[0, t].imshow(_mark_boundaries(img, seg))
        ax[1, t].imshow(seg, aspect="auto")
        for sp in np.unique(seg):
            ys, xs = np.nonzero(seg == sp)
            if len(ys):
                ax[1, t].text(xs.mean(), ys.mean(), str(sp), fontsize=10,
                              color="pink")
    path = vis.save_figure(fig, "superpixel_adj")

    if As is not None and len(As):
        fig2, ax2 = plt.subplots(1, len(As), figsize=(4 * len(As), 4),
                                 squeeze=False)
        for i, A in enumerate(As):
            ax2[0, i].imshow(np.asarray(A))
        vis.save_figure(fig2, "adjacency_heatmaps")
    return path
