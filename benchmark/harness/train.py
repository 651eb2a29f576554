"""Training cells: the program's own step, built through its entry points,
driven from the seed.

Set-up parses the configuration's flags with the trainer's parser
(``utils/arguments.py::train_args``), builds ``CRW(model_config(args))``,
loads the seeded weights and puts it under ``create_train_state(...,
make_optimizer(...))``. The traffic mix's pool of input batches is made
on the card. The first three steps go through the window's own call on
three different batches; their losses, the first gradient (from Adam's
first moment after step 1) and the parameters' change after step 3 are
kept for the check. Further steps warm up, then the window steps the pool
in turn, fetching the loss every ``--print-freq`` steps as the trainer
does.

On more than one card (a process group of one process a card,
``harness/ranks.py``) the configuration's ``--batch-size`` is a card's:
the program's global batch is that times the cell's chips, as
``train_torch.sh --data-parallel`` splits it. Every rank makes the pool's
global batches from the seed and keeps its row block, draws from a
``GlobalBatchGenerator`` and steps under ``create_train_state(...,
group=group)``: train-mode BN's moments span the group and the gradients
are averaged over it each step. The ranks agree, at the steps that fetch
the loss, on rank 0's clock: when the window ends and when its traced
stretch starts (profiled on rank 0 alone). The reference runs on every rank over its row block, made again
from the seed and cut by a plain slice, its moments, losses and
gradients summed over the group (``reference/crw.py::global_batch``)."""

from __future__ import annotations

import contextlib
import math
import time

import torch
import torch.distributed as dist

from harness import common, inputs
from harness.trace import profiled

RECORDED_STEPS = 3
BETA1 = 0.9


class TrainCell:
    def __init__(self, cell: dict, seed: int, device, group=None):
        from videowalk_tpu_torch.utils.arguments import train_args

        self.cell, self.seed = cell, int(seed)
        self.device = torch.device(device)
        self.traffic = cell["traffic"]
        argv = (list(cell["config"]["train_flags"])
                + ["--device", str(self.device), "--output-dir", "",
                   "--logs-dir", ""])
        self.args = train_args(argv)
        self.args.batch_size *= int(cell["chips"])     # the global batch
        self.group = group
        self.rank = dist.get_rank(group) if group is not None else 0
        self.world = dist.get_world_size(group) if group is not None else 1
        if self.world != int(cell["chips"]):
            raise ValueError(f"{cell['name']} asks for {cell['chips']} "
                             f"cards; {self.world} processes")
        self.superpixel = self.traffic["nodes"] == "superpixel"

    # ----------------------------------------------------------- set-up

    def setup(self) -> None:
        from videowalk_tpu_torch.parallel import (create_train_state,
                                                  make_optimizer,
                                                  make_train_step)

        a = self.args
        if self.device.type == "cuda":
            from videowalk_tpu_torch.ops import _build

            _build.build_all()
        model = self._model()
        weights = common.seeded_weights(self.template, self.seed, self.device)
        model.load_state_dict(weights)
        self.state = create_train_state(
            model, make_optimizer(lr=a.lr, optim=a.optim, momentum=a.momentum),
            device=self.device, group=self.group)
        self.step_fn = make_train_step()
        from videowalk_tpu_torch.core.rng import GlobalBatchGenerator
        from videowalk_tpu_torch.ops.slic import slic_fused

        self._slic = slic_fused
        self.gen = (GlobalBatchGenerator(self.device, self.rank, self.world)
                    if self.world > 1 else torch.Generator(self.device))
        self.pool = [self._make_batch(i)
                     for i in range(int(self.traffic["pool"]))]
        self.n_steps = 0
        self.records = self._recorded_steps(weights)
        del weights
        for _ in range(int(self.traffic.get("warmup_steps", 2))):
            self._step()
        self._fetch(self._last)
        if self.world > 1:
            self._agree(False, False)      # every rank set up

    def _model(self):
        """The program's model as the trainer builds it (on the host, its
        weights replaced after); its ``state_dict``'s shapes kept."""
        from videowalk_tpu_torch.cli.train import model_config
        from videowalk_tpu_torch.models import CRW

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = CRW(model_config(self.args))
        self.template = {k: torch.empty(v.shape, dtype=v.dtype,
                                        device="meta")
                         for k, v in model.state_dict().items()}
        return model

    def _global_unit(self, i: int) -> torch.Tensor:
        """The pool's global batch ``i`` of clips in ``[0, 1]``, from the
        seed."""
        a, t = self.args, self.traffic
        gen = torch.Generator(self.device)
        gen.manual_seed(common.subseed(self.seed, f"batch{i}"))
        return inputs.moving_textures(gen, a.batch_size, a.clip_len,
                                      a.img_size, int(t["texture_cell"]),
                                      self.device)

    def _make_batch(self, i: int) -> dict:
        """The program's input: this rank's row block of the pool's global
        batch ``i``, as the program's ``shard_batch`` cuts it."""
        unit = self._global_unit(i)
        if self.world > 1:
            from videowalk_tpu_torch.parallel import shard_batch

            # a copy: the global batch goes
            unit = shard_batch(unit, self.rank, self.world).clone()
        return self._prepare(unit)

    def _reference_batch(self, i: int) -> dict:
        """The reference's input: the same rows, made again from the seed
        and cut by a plain slice, not by the program."""
        unit = self._global_unit(i)
        b = len(unit) // self.world
        return self._prepare(unit[self.rank * b:(self.rank + 1) * b].clone())

    def _prepare(self, unit: torch.Tensor) -> dict:
        if self.superpixel:
            return dict(unit=unit, frames=inputs.normalize(unit))
        grid = inputs.patch_grid(inputs.normalize(unit),
                                 int(self.args.patch_size[0]))
        return dict(patches=grid.contiguous())

    def _step(self):
        """One step of the window's path on the pool's next batch."""
        a = self.args
        batch = self.pool[self.n_steps % len(self.pool)]
        self.gen.manual_seed(common.subseed(self.seed, f"step{self.n_steps}"))
        if self.superpixel:
            mask = self._slic(batch["unit"], a.num_sp, float(a.compactness))
            metrics = self.step_fn(self.state, batch["frames"], self.gen,
                                   sp_mask=mask)
            self._mask = mask
        else:
            metrics = self.step_fn(self.state, batch["patches"], self.gen)
        self.n_steps += 1
        self._last = metrics
        return metrics

    def _fetch(self, metrics) -> float:
        loss = float(metrics["loss"])          # waits for this step
        if not math.isfinite(loss):
            raise FloatingPointError(f"non-finite loss {loss} at step "
                                     f"{self.n_steps}")
        return loss

    def _named_params(self):
        return [(k, p) for k, p in self.state.model.named_parameters()
                if p.requires_grad]

    def _recorded_steps(self, weights: dict) -> dict:
        """The first steps through the window's own call: each loss, the
        gradient norm of each leaf as Adam got it at step 1 and the whole
        gradient (on the host: ``grad1``), the norm of each leaf's change
        after the last recorded step, and (superpixel nodes) step 1's SLIC
        labels."""
        losses, grad, grad1, labels = [], None, None, None
        for i in range(RECORDED_STEPS):
            losses.append(self._fetch(self._step()))
            if i == 0:
                opt = self.state.optimizer
                grad = torch.stack([
                    torch.linalg.vector_norm(opt.state[p]["exp_avg"])
                    / (1 - BETA1) if "exp_avg" in opt.state[p]
                    else torch.zeros((), device=p.device)
                    for _, p in self._named_params()])
                grad1 = {k: (opt.state[p]["exp_avg"].float().cpu()
                             / (1 - BETA1)) if "exp_avg" in opt.state[p]
                         else torch.zeros(p.shape)
                         for k, p in self._named_params()}
                if self.superpixel:
                    labels = self._mask.clone()
        change = torch.stack([
            torch.linalg.vector_norm(p.detach() - weights[k])
            for k, p in self._named_params()])
        names = [k for k, _ in self._named_params()]
        return dict(losses=losses,
                    grad=dict(zip(names, grad.tolist())), grad1=grad1,
                    change=dict(zip(names, change.tolist())),
                    labels=labels)

    # ----------------------------------------------------------- window

    def window(self, seconds: float, trace: bool) -> dict:
        """Step for ``seconds``; the last step's loss is fetched at the
        end. Step periods come from an event recorded at each step's start
        on the step's stream, read after the window. With ``trace``, a
        stretch of ``trace_steps`` steps halfway through runs under the
        profiler with the host's operators recorded, then another without
        them (for the device's idle share); both are left out of the clip
        count and the time. On more than one card the window ends, and
        the traced stretch starts, at the first step that fetches the
        loss once rank 0's clock says so; the clips are the global
        batch's."""
        every = max(1, self.args.print_freq)
        k_trace = int(self.traffic.get("trace_steps", 8))
        marks, traced = [], None
        self._sync()
        t0 = time.perf_counter()
        steps = 0
        while True:
            marks.append(self._mark())
            self._step()
            steps += 1
            fetched = steps % every == 0
            if fetched:
                self._fetch(self._last)
            elapsed = time.perf_counter() - t0
            stop = elapsed >= seconds
            start = trace and traced is None and elapsed >= seconds / 2
            if self.world > 1:
                if not fetched:
                    continue
                stop, start = self._agree(stop, start)
            if stop:
                break
            if start:
                traced, idle = {}, {}
                with self._profiled(traced, spans=self._trace_spans()):
                    for _ in range(k_trace):
                        self._step()
                    self._fetch(self._last)
                with self._profiled(idle, cpu=False):
                    for _ in range(k_trace):
                        self._step()
                    self._fetch(self._last)
        marks.append(self._mark())
        self._fetch(self._last)
        wall = time.perf_counter() - t0
        out = dict(steps=steps, clips=steps * self.args.batch_size,
                   wall_s=wall, periods_ms=self._periods(marks))
        if traced is not None and "trace" in traced:
            out.update(trace=traced["trace"], idle_trace=idle["trace"],
                       trace_steps=k_trace,
                       untraced_wall_s=wall - traced["wall_s"]
                       - idle["wall_s"])
        return out

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _agree(self, stop: bool, start: bool) -> tuple[bool, bool]:
        """Rank 0's ``(stop, start)`` on every rank: one all-reduce, which
        every rank waits for."""
        flags = torch.tensor([stop, start] if self.rank == 0 else [0, 0],
                             dtype=torch.int32, device=self.device)
        dist.all_reduce(flags, op=dist.ReduceOp.MAX, group=self.group)
        stop, start = flags.tolist()
        return bool(stop), bool(start)

    def _profiled(self, out: dict, **kw):
        """The profiler on rank 0; the other ranks step alike untraced."""
        if self.rank != 0:
            return contextlib.nullcontext()
        return profiled(self.device, out, **kw)

    def _mark(self):
        """A step's start: an event on the step's stream (the host's clock
        on the CPU)."""
        if self.device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _periods(self, marks) -> list:
        if self.device.type != "cuda":
            return [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]

    def _trace_spans(self):
        """The benchmark's own spans around calls into the layers the
        per-layer metrics read: the superpixel pooling weights."""
        if not self.superpixel:
            return {}
        from videowalk_tpu_torch.models import crw

        return {(crw, "superpixel_pool_weights"): "bench.sp_pool"}

    # ----------------------------------------------------------- check

    @staticmethod
    def attempted(window: dict) -> int:
        return window["steps"]

    def program_records(self) -> dict:
        return self.records

    @staticmethod
    def compare(program: dict, reference: dict) -> dict:
        return compare(program, reference)

    def free(self) -> None:
        """Drop the program's state before the reference runs (each rank
        on its own card)."""
        del self.state, self.step_fn, self._last
        self._mask = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_records(self, mode: str = "f32", fault: str | None = None
                          ) -> dict:
        """The plain reference's readings of the recorded steps, from the
        seeded weights and the same batches, made again from the seed (on
        more than one card, every rank over its row block of the global
        batch, cut by a plain slice). ``mode``: the
        reference's precision (``f32``, or ``fp8`` for the control);
        ``fault="half_batch"``: the loss of the batch's first half alone
        (of each rank's row block)."""
        from reference import crw as ref
        from reference import slic as ref_slic

        a = self.args
        dev = self.device
        weights = common.seeded_weights(self.template, self.seed, dev)
        batches = [self._reference_batch(i) for i in range(RECORDED_STEPS)]
        labels = []
        if self.superpixel:
            dtype = torch.bfloat16 if mode != "f32" else torch.float32
            for b in batches:
                labels.append(ref_slic.slic(b["unit"], a.num_sp,
                                            float(a.compactness),
                                            feature_dtype=dtype))
        dil = a.dilation_kernel_size if a.dilate_superpixels else None

        def loss_fn(sd, i, batch):
            if self.superpixel:
                frames, lab = batch["frames"], labels[i]
                if fault == "half_batch":
                    frames, lab = frames[:len(frames) // 2], lab[:len(lab) // 2]
                q = ref.superpixel_nodes(sd, frames, lab,
                                         n_slots=a.max_sp_num,
                                         dilation_kernel_size=dil, mode=mode)
            else:
                x = batch["patches"]
                if fault == "half_batch":
                    x = x[:len(x) // 2]
                q = ref.patch_nodes(sd, x, mode=mode)
            B, _, T, N = q.shape
            gen = torch.Generator(dev)
            gen.manual_seed(common.subseed(self.seed, f"step{i}"))
            # the rank's rows of the global batch's draws
            r, w = self.rank, self.world
            m12, m21 = (m[r * B:(r + 1) * B] for m in ref.dropout_masks(
                (B * w, T - 1, N, N), a.dropout, gen, dev))
            return ref.walk_loss(q, a.temp, m12, m21)

        with ref.precision("f32" if mode == "fp8" else mode), \
                ref.global_batch(self.group):
            losses, grad1, after = ref.adam_steps(weights, batches, loss_fn,
                                                  lr=a.lr)
        names = list(after)
        norm = torch.linalg.vector_norm
        return dict(
            losses=losses,
            grad=dict(zip(names, torch.stack(
                [norm(grad1[k]) for k in names]).tolist())),
            grad1=grad1,
            change=dict(zip(names, torch.stack(
                [norm(after[k] - weights[k]) for k in names]).tolist())),
            labels=labels[0] if labels else None)


def compare(program: dict, reference: dict) -> dict:
    """``TrainCell.compare``: the numbers the check can hold to limits:

    - ``loss_gap``: the largest of the recorded steps' ``|L - L_ref| /
      |L_ref|``; ``loss1_gap`` the first step's alone;
    - ``grad_gap``: over leaves, the largest ``| |g| - |g_ref| |`` at step
      1 over the larger of ``|g_ref|`` and the median leaf's;
      ``grad_median_gap`` the median leaf's gap;
    - ``grad_vec_gap`` and ``grad_vec_median_gap``: the same of each
      leaf's whole step-1 gradient, ``|g - g_ref|`` over the larger of
      ``|g_ref|`` and the median leaf's (sees which rows the gradient
      came from, where the norms of alike clips agree);
    - ``change_gap`` and ``change_median_gap``: the same of each leaf's
      change after the recorded steps, over leaves whose reference
      gradient is at least a thousandth of the median leaf's (the others
      move under Adam by round-off);
    - ``slic_mismatch`` (superpixel nodes): the share of step 1's pixels
      whose SLIC label differs."""
    import statistics

    def gaps(prog, ref, keys):
        med = statistics.median(ref[k] for k in keys)
        return [abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys]

    out = {}
    loss = [abs(a - b) / abs(b) for a, b in
            zip(program["losses"], reference["losses"])]
    out["loss1_gap"], out["loss_gap"] = loss[0], max(loss)
    g_ref = reference["grad"]
    g = gaps(program["grad"], g_ref, list(g_ref))
    out["grad_gap"], out["grad_median_gap"] = max(g), statistics.median(g)
    v = vector_gaps(program["grad1"], reference["grad1"], g_ref)
    out["grad_vec_gap"] = max(v.values())
    out["grad_vec_median_gap"] = statistics.median(v.values())
    g_med = statistics.median(g_ref.values())
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    c = gaps(program["change"], reference["change"], moved)
    out["change_gap"], out["change_median_gap"] = max(c), statistics.median(c)
    if reference.get("labels") is not None:
        out["slic_mismatch"] = float(
            (program["labels"].to(torch.int64)
             != reference["labels"].to(torch.int64)).double().mean())
    return out


def vector_gaps(grad1: dict, ref1: dict, ref_norms: dict) -> dict:
    """Each leaf's ``|g - g_ref|`` over the larger of ``|g_ref|`` and the
    median leaf's (``ref_norms``: the reference's norms)."""
    import statistics

    med = statistics.median(ref_norms.values())
    return {k: float(torch.linalg.vector_norm(
                grad1[k].to(r.device, torch.float32) - r))
            / max(ref_norms[k], med) for k, r in ref1.items()}
