"""Eval cells: label propagation through the evaluator's own loop,
``cli/test.py::test``, over a seeded pool of synthetic DAVIS-480p videos.

Set-up parses the configuration's eval flags with the evaluator's parser
(``utils/arguments.py::test_args``), builds the model with
``cli/test.py::build_model``, loads the seeded weights, makes the pool of
videos on the card (the same lengths and object counts for every seed; the
seed picks their content and order) and warms up with one whole pass
over the pool: every video length and label count the window meets, and
with them every chunk size ``encode_video`` cuts (1 to 5 frames for the
pool's lengths), so the caching allocator and cuDNN have seen each shape
before the window. The window runs whole passes over the pool, video
after video; a video's label maps reach the host before ``test``
returns. The predictions go to
a dump that keeps them in memory and writes no file."""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from harness import common, inputs
from harness.trace import profiled


class EvalCell:
    def __init__(self, cell: dict, seed: int, device):
        from videowalk_tpu_torch.utils.arguments import test_args

        self.cell, self.seed = cell, int(seed)
        self.device = torch.device(device)
        self.traffic = cell["traffic"]
        self.args = test_args(list(cell["config"]["eval_flags"])
                              + ["--device", str(self.device),
                                 "--save-path", ""])

    def setup(self) -> None:
        from videowalk_tpu_torch.cli.test import build_model
        from videowalk_tpu_torch.eval import test_utils

        a, t = self.args, self.traffic
        if self.device.type == "cuda":
            from videowalk_tpu_torch.ops import _build

            _build.build_all()
        with contextlib.redirect_stdout(sys.stderr):
            self.model = build_model(a, self.device)
        self.template = {k: torch.empty(v.shape, dtype=v.dtype,
                                        device="meta")
                         for k, v in self.model.state_dict().items()}
        self.model.load_state_dict(common.seeded_weights(
            self.template, self.seed, self.device))
        a.mapScale = test_utils.infer_downscale(self.model.spec.map_scale)
        a.use_lab = False
        lengths, objects = list(t["lengths"]), list(t["objects"])
        self.videos = []
        for i, (n, k) in enumerate(zip(lengths, objects)):
            gen = torch.Generator(self.device)
            gen.manual_seed(common.subseed(self.seed, f"video{i}"))
            frames, labels0 = inputs.davis_video(
                gen, int(n), int(k), int(t["height"]), int(t["width"]),
                int(t["texture_cell"]), self.device)
            self.videos.append(inputs.video_item(frames, labels0,
                                                 a.videoLen))
        rng = np.random.RandomState(common.subseed(self.seed, "order") % 2**32)
        self.order = [int(i) for i in rng.permutation(len(self.videos))]
        self.sample = int(rng.randint(len(self.videos)))
        self.captured = None
        with contextlib.redirect_stdout(sys.stderr):
            for item in self.videos:
                self._run(item)
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run(self, item, capture: bool = False) -> dict:
        """One video through ``cli/test.py::test``; with ``capture``, the
        trunk's output and the predictions are kept for the check."""
        from videowalk_tpu_torch.cli.test import test

        preds, feats = {}, []

        def dump(pred, lbl_map, img, outpath, **kw):
            if capture:
                preds[int(outpath.rsplit("_", 1)[1])] = pred

        hook = None
        if capture:
            hook = self.model.encoder.model.register_forward_hook(
                lambda m, i, o: feats.append(o.detach().float().clone()))
        try:
            stats = test([item], self.model, self.args, dump=dump)[0]
        finally:
            if hook is not None:
                hook.remove()
        if capture:
            self.captured = dict(
                feats=torch.cat(feats),
                preds=np.stack([preds[i] for i in range(len(preds))]))
        return stats

    def window(self, seconds: float, trace: bool) -> dict:
        """Whole passes over the pool, each video once in the seeded
        order, until a pass ends after ``seconds`` have passed: every run
        does the same work, whole passes of the same videos. The sample
        video's first pass is captured. With ``trace`` the video due
        halfway through runs first under the profiler with the host's
        operators recorded, then again without them (for the device's
        idle share); both are left out of every count."""
        done = dict(videos=0, frames=0, targets=0, encode_s=0.0, runs=[])
        traced = None
        n = len(self.order)
        k = 0
        self._sync()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            while True:
                idx = self.order[k % n]
                k += 1
                if trace and traced is None and time.perf_counter() - t0 >= \
                        seconds / 2:
                    traced, idle = {}, {}
                    with profiled(self.device, traced):
                        st = self._run(self.videos[idx])
                    with profiled(self.device, idle, cpu=False):
                        self._run(self.videos[idx])
                    traced.update(run=(st["frames"], st["targets"],
                                       self.videos[idx][2].shape[-1]))
                capture = idx == self.sample and self.captured is None
                st = self._run(self.videos[idx], capture=capture)
                done["videos"] += 1
                done["frames"] += st["frames"]
                done["targets"] += st["targets"]
                done["encode_s"] += st["encode_s"]
                done["runs"].append((st["frames"], st["targets"],
                                     self.videos[idx][2].shape[-1]))
                if k % n == 0 and time.perf_counter() - t0 >= seconds:
                    break
        wall = time.perf_counter() - t0
        out = dict(done, wall_s=wall)
        if traced is not None:
            out.update(trace=traced["trace"], idle_trace=idle["trace"],
                       trace_run=traced["run"],
                       untraced_wall_s=wall - traced["wall_s"]
                       - idle["wall_s"])
        return out

    @staticmethod
    def attempted(window: dict) -> int:
        return window["targets"]

    @property
    def channels(self) -> int:
        return self.model.spec.hid_dim

    def program_records(self) -> dict:
        return self.captured

    @staticmethod
    def compare(program: dict, reference: dict) -> dict:
        return compare(program, reference)

    def free(self) -> None:
        del self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_records(self, mode: str = "f32") -> dict:
        """The plain reference over the sample video: its trunk's features
        (``mode``: ``f32``, or ``tf32`` for the control) and propagation,
        from the seeded weights and the same frames."""
        from reference import crw as ref
        from reference.propagation import propagate

        a = self.args
        imgs, _, lbls, _, _, _ = self.videos[self.sample]
        sd = common.seeded_weights(self.template, self.seed, self.device)
        feats = []
        with ref.precision(mode), torch.no_grad():
            for b in range(0, len(imgs), 8):
                x = torch.from_numpy(imgs[b:b + 8]).to(self.device)
                x = ref.normalize_frames(x.to(torch.float32) / 255.0)
                feats.append(ref.trunk(sd, x.permute(0, 3, 1, 2),
                                       train=False))
            feats = torch.cat(feats)
            preds = propagate(
                ref.l2_normalize(feats, dim=1), torch.from_numpy(lbls),
                n_context=a.videoLen, long_mem=list(a.long_mem),
                topk=a.topk, temperature=a.temperature, radius=a.radius)
        return dict(feats=feats, preds=preds.cpu().numpy())


def compare(program: dict, reference: dict) -> dict:
    """``EvalCell.compare``: the numbers the check holds to its limits: ``feat_gap``, the largest
    distance between the program's and the reference's L2-normalized
    feature vectors over every cell of every frame of the sample video;
    ``label_gap``, the mean absolute difference of their predicted soft
    labels over every target cell and label."""
    def unit(f):
        return f / torch.clamp(torch.linalg.vector_norm(f, dim=1,
                                                        keepdim=True),
                               min=1e-12)

    fp, fr = unit(program["feats"]), unit(reference["feats"].to(
        program["feats"].device))
    return dict(
        feat_gap=float(torch.linalg.vector_norm(fp - fr, dim=1).max()),
        label_gap=float(np.abs(program["preds"] - reference["preds"]).mean()))
