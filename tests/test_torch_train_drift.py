"""N steps of training, the port against the JAX package, from one init
(``state_from_flax``) on the same seeded batches with the same injected
edge-dropout masks (rate 0.1) and Adam at 3e-4: 8 steps of a narrow
patch-mode CRW (``scratch`` without layer3 and layer4, B=2, T=4, N=4
patches of 16 px) and 4 steps of a small superpixel-mode CRW (the same
trunk, 32x32 frames, Voronoi ids over 12 node slots, L1 dilation k=7).
After every step the loss, every parameter and every BN running statistic
are held to JAX. Both sides run in f64 (JAX under x64), as
``tests/test_torch_train_step.py``'s gradient test does, with the walk off
the fused path; the port's steps are its own ``make_train_step`` on a
``create_train_state``. The walk runs at T 0.1: at 0.05 the JAX walk's f32
gradient underflows where nodes are near-parallel (ROADMAP.md, Queue 3),
so JAX is no reference there over several steps.

Tolerances, from the one-step tests: in f64 the two sides' gradients agree
within 3e-5 of each tensor's largest entry
(``test_crw_grads_match_jax_in_float64``), and the f32 tests hold the loss
to rtol 1e-4 and BN's new statistics to 1e-4 of their scale. Adam moves
each parameter by about ``lr`` a step along its gradient's sign, so the
gradients' 3e-5 reaches the parameters only through entries whose gradient
is that small, and the gap then shrinks against the distance travelled.
Read here (largest over the steps): loss 9.1e-6, parameter gap 1.5e-3,
statistics 4.6e-5. Held:
- loss: rtol 1e-4 at every step (the one-step f32 bound);
- parameters: ``||p_port - p_jax|| / ||p_jax - p_0||`` over all tensors,
  the gap against the distance travelled, at most 5e-3 at every step;
- BN running statistics: within 2e-4 of their scale at every step (2x the
  one-step f32 bound: the statistics follow the parameters' gap).
A planted fault must break them, and does by far: BN's running statistics
updated with momentum 0.9 (flax's decay taken for torch's momentum; the
statistics part by 0.77-4.8 of their scale), or Adam's bias correction one
step off (its step count starting at 1; the parameters part by 0.17-0.26
of the distance travelled)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from videowalk_tpu.core import walk as jw
from videowalk_tpu.models import CRW as JaxCRW, CRWConfig as JaxConfig
from videowalk_tpu.parallel import make_optimizer as jax_make_optimizer

from videowalk_tpu_torch.models import CRW, CRWConfig
from videowalk_tpu_torch.models.resnet import BatchNorm
from videowalk_tpu_torch.parallel import (create_train_state, make_optimizer,
                                          make_train_step)
from videowalk_tpu_torch.utils.checkpoint import state_from_flax

torch.set_num_threads(1)

TEMP, RATE, LR, SP = 0.1, 0.1, 3e-4, 12
NARROW = dict(model_type="scratch", remove_layers=("layer3", "layer4"))
LOSS_RTOL, PARAM_GAP, STATS_ATOL = 1e-4, 5e-3, 2e-4
CASES = dict(
    patch=dict(steps=8, cfg=NARROW),
    superpixel=dict(steps=4, cfg=dict(NARROW, max_sp_num=SP,
                                      dilate_superpixels=True,
                                      dilation_kernel_size=7)))


def voronoi_ids(B, T, h, w, rng):
    """(B, T, h, w) int32 ids: per frame 6..9 seed points, each a distinct
    random slot of the ``SP``; the other slots absent."""
    ys, xs = np.mgrid[:h, :w]
    out = np.zeros((B, T, h, w), np.int32)
    for b in range(B):
        for t in range(T):
            n = rng.randint(6, 10)
            slots = rng.permutation(SP)[:n]
            py, px = rng.rand(n) * h, rng.rand(n) * w
            d = (ys[..., None] - py) ** 2 + (xs[..., None] - px) ** 2
            out[b, t] = slots[d.argmin(-1)]
    return out


def batches(case: str) -> list:
    """Each step's (x, sp_mask or None, m12, m21), seeded."""
    rng = np.random.RandomState(11)
    out = []
    for _ in range(CASES[case]["steps"]):
        if case == "patch":
            x, sp, n = rng.randn(2, 4, 4, 16, 16, 3), None, 4
        else:
            x, n = rng.randn(2, 4, 32, 32, 3), SP
            sp = voronoi_ids(2, 4, 32, 32, rng)
        m12, m21 = (rng.rand(2, 3, n, n) < RATE for _ in range(2))
        out.append((x, sp, m12, m21))
    return out


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_walk_loss(q, m12, m21):
    """``core/walk.py::crw_walk_loss`` with given masks (it draws them from
    a key): affinity -> -1e20 fill -> ZeroSoftmax -> palindrome products
    -> cross-entropy, the JAX package's own pieces."""
    As = jnp.moveaxis(jw.affinity(q[:, :, :-1], q[:, :, 1:]), 1, 0)
    AsT = jnp.swapaxes(As, -1, -2)
    As = jnp.where(jnp.moveaxis(m12, 1, 0), -1e20, As)
    AsT = jnp.where(jnp.moveaxis(m21, 1, 0), -1e20, AsT)
    AAs = jw.palindrome_products(jw.zero_softmax(As / TEMP),
                                 jw.zero_softmax(AsT / TEMP))
    losses, _ = jax.vmap(jw.walk_xent_loss)(AAs)
    return jnp.sum(losses) / AAs.shape[0]


@functools.lru_cache(maxsize=None)
def jax_run(case: str):
    """The JAX trajectory: the f32 init (numpy), then after each step the
    loss and the f64 variables (numpy)."""
    spec = CASES[case]
    data = batches(case)
    x0, sp0 = data[0][0], data[0][1]
    kw = {} if sp0 is None else {"sp_mask": jnp.asarray(sp0)}
    init = _np(dict(JaxCRW(JaxConfig(temperature=TEMP, **spec["cfg"])).init(
        jax.random.PRNGKey(0), jnp.asarray(x0, jnp.float32), train=False,
        **kw)))
    traj = []
    with jax.enable_x64(True):
        jm = JaxCRW(JaxConfig(temperature=TEMP, dtype=jnp.float64,
                              fused_walk="off", **spec["cfg"]))
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                   init)
        params, stats = v["params"], v["batch_stats"]
        tx = jax_make_optimizer(lr=LR)
        opt = tx.init(params)

        def loss_fn(p, s, x, sp, m12, m21):
            kw = {} if sp is None else {"sp_mask": sp}
            (q, _), upd = jm.apply({"params": p, "batch_stats": s}, x,
                                   just_feats=True, train=True,
                                   mutable=["batch_stats"], **kw)
            return _jax_walk_loss(q, m12, m21), upd["batch_stats"]

        grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        for x, sp, m12, m21 in data:
            (loss, stats), g = grad(params, stats, jnp.asarray(x),
                                    None if sp is None else jnp.asarray(sp),
                                    jnp.asarray(m12), jnp.asarray(m21))
            updates, opt = tx.update(g, opt, params)
            params = optax.apply_updates(params, updates)
            traj.append((float(loss), _np({"params": params,
                                           "batch_stats": stats})))
    return init, traj


class Injected(torch.nn.Module):
    """The CRW with each step's edge-dropout masks given."""

    def __init__(self, model):
        super().__init__()
        self.crw, self.masks = model, None

    def forward(self, x, **kw):
        return self.crw(x, walk_masks=self.masks, **kw)


def port_run(case: str, fault: str | None = None) -> list:
    """The port's steps from JAX's init; per step (loss rel. error,
    parameter gap over the distance travelled, BN statistics' error over
    their scale) against ``jax_run``."""
    spec = CASES[case]
    init, traj = jax_run(case)
    model = CRW(CRWConfig(temperature=TEMP, edgedrop_rate=RATE,
                          dtype=torch.float64, fused_walk="off",
                          **spec["cfg"]))
    model.load_state_dict(state_from_flax(init), strict=True)
    model.double()
    if fault == "bn_momentum":
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.momentum = 0.9
    wrapped = Injected(model)
    state = create_train_state(wrapped, make_optimizer(lr=LR), device="cpu")
    if fault == "adam_bias":
        for group in state.optimizer.param_groups:
            for p in group["params"]:
                state.optimizer.state[p] = dict(
                    step=torch.tensor(1.0), exp_avg=torch.zeros_like(p),
                    exp_avg_sq=torch.zeros_like(p))
    step = make_train_step()
    p0 = {k: v.clone() for k, v in model.named_parameters()}
    rows = []
    for (x, sp, m12, m21), (loss_j, v_j) in zip(batches(case), traj):
        wrapped.masks = (torch.from_numpy(m12), torch.from_numpy(m21))
        kw = {} if sp is None else {"sp_mask": torch.from_numpy(sp)}
        metrics = step(state, torch.from_numpy(x), None, **kw)
        want = state_from_flax(v_j)
        got = model.state_dict()
        num = den = 0.0
        stats_err = 0.0
        for k, w in want.items():
            g, w = got[k].double(), w.double()
            if k in p0:
                num += float(((g - w) ** 2).sum())
                den += float(((w - p0[k].detach().double()) ** 2).sum())
            elif not k.endswith("num_batches_tracked"):
                stats_err = max(stats_err, float((g - w).abs().max())
                                / max(1.0, float(w.abs().max())))
        rows.append(dict(loss_rel=abs(float(metrics["loss"]) - loss_j)
                         / abs(loss_j), param_gap=(num / den) ** 0.5,
                         stats_err=stats_err))
    return rows


def within(rows) -> bool:
    return all(r["loss_rel"] <= LOSS_RTOL and r["param_gap"] <= PARAM_GAP
               and r["stats_err"] <= STATS_ATOL for r in rows)


@pytest.mark.parametrize("case", sorted(CASES))
def test_n_steps_stay_with_jax(case):
    rows = port_run(case)
    assert len(rows) == CASES[case]["steps"]
    assert within(rows), rows


@pytest.mark.parametrize("fault", ["bn_momentum", "adam_bias"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_a_planted_fault_breaks_the_tolerances(case, fault):
    rows = port_run(case, fault)
    assert not within(rows), rows
