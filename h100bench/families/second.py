"""SECOND / VoxelNet cells: the port's inference (``make_second_infer_fn``, its
detections copied to the host by ``to_host``) and training
(``Trainer.step_fn`` with the trainer ``train_second`` builds), their
weights and inputs from the seed, the spans of a traced run, the work the
roofline and MFU metrics count, and the comparison with the plain reference
that decides ``correct``.
"""

from __future__ import annotations

import gc
import math
import random
import tempfile
from typing import Dict, List

import numpy as np
import torch

from h100bench import harness
from h100bench.counts import sparse_middle, voxelnet as voxelnet_counts
from h100bench.reference import second as ref

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
WEIGHT_SALT = 0x9E3779B97F4A7C15
CLS_PRIOR = math.log(0.01 / 0.99)  # the focal-loss prior of the class head's bias


def port_config(doc: dict):
    """The port's ``VoxelNetConfig`` from a configuration file."""
    from lyft3d_tpu_torch.models.second.voxelnet import VoxelNetConfig
    from lyft3d_tpu_torch.ops.anchors import AnchorSpec
    from lyft3d_tpu_torch.ops.voxelize import VoxelGrid

    e = doc["experiment"]
    grid = VoxelGrid(point_cloud_range=tuple(e["point_cloud_range"]), voxel_size=tuple(e["voxel_size"]),
                     block_filtering=e["block_filtering"], block_factor=e["block_factor"],
                     block_size=e["block_size"], height_threshold=e["height_threshold"])
    specs = tuple(AnchorSpec(size=tuple(a["size"]), z_center=a["z_center"],
                             matched_threshold=a["matched_threshold"],
                             unmatched_threshold=a["unmatched_threshold"], class_id=i + 1)
                  for i, a in enumerate(e["anchors"]))
    tup = lambda k: tuple(e[k])  # noqa: E731
    return VoxelNetConfig(
        grid=grid, max_voxels=e["max_voxels"], max_points_per_voxel=e["max_points_per_voxel"],
        encoder=e["encoder"], encoder_features=tup("encoder_features"), middle=e["middle"],
        middle_features=tup("middle_features"), middle_max_voxels=tup("middle_max_voxels"),
        middle_norm=e["middle_norm"], middle_z_slab=e["middle_z_slab"], similarity=e["similarity"],
        anchor_specs=specs, rpn_layer_nums=tup("rpn_layer_nums"), rpn_strides=tup("rpn_strides"),
        rpn_filters=tup("rpn_filters"), rpn_up_strides=tup("rpn_up_strides"),
        rpn_up_filters=tup("rpn_up_filters"))


def make_weights(model: torch.nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter of ``model`` from the seed, made on the device in one
    normal draw and cut into leaves, in each leaf's own dtype; loaded into
    the model. Returns the served values (``name → tensor``) for the
    reference. Convolution and linear weights: normal with std
    ``1/sqrt(fan_in)``, a sparse conv's ``(27, Cin, Cout)`` kernel
    ``sqrt(2/(27·Cin))``; norm scales ``1 + 0.1 N``; biases ``0.1 N``, the class
    head's about the focal-loss prior."""
    named = [(n, p) for n, p in model.named_parameters()]
    total = sum(p.numel() for _, p in named)
    g = torch.Generator(device=device).manual_seed((seed + WEIGHT_SALT) % 2 ** 64)
    draw = torch.randn(total, generator=g, device=device)
    kinds = {}
    for mname, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            kinds[f"{mname}.{pname}" if mname else pname] = (type(mod), pname)
    served, at = {}, 0
    with torch.no_grad():
        for name, p in named:
            x = draw[at : at + p.numel()].view(p.shape)
            at += p.numel()
            mod_type, pname = kinds[name]
            if pname == "kernel":
                x = x * math.sqrt(2.0 / (27 * p.shape[1]))
            elif issubclass(mod_type, (torch.nn.LayerNorm, torch.nn.GroupNorm, torch.nn.BatchNorm2d)):
                x = 1.0 + 0.1 * x if pname == "weight" else 0.1 * x
            elif pname == "weight" and p.dim() >= 2:
                x = x / math.sqrt(p[0].numel())
            elif pname == "bias":
                x = 0.1 * x + (CLS_PRIOR if name.endswith("rpn.cls.bias") else 0.0)
            else:
                raise TypeError(f"no rule for the weight {name} of a {mod_type.__name__}")
            p.copy_(x.to(p.dtype))
            served[name] = x.to(p.dtype)
    return served


def ref_weights(served: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().float().clone() for k, v in served.items()}


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class SecondCell:
    """What both entries share: the configuration, the pool, the weights."""

    def __init__(self, run: "harness.RunContext"):
        self.run = run
        self.doc = run.config
        self.device = run.device
        self.dtype = DTYPES[self.doc["dtype"]]
        self.vcfg = port_config(self.doc)
        self.rcfg = ref.config_from_experiment(self.doc["experiment"])
        self.in_features = self.doc["point_features"]
        anchors = [(a["size"], a["z_center"]) for a in self.doc["experiment"]["anchors"]]
        gen = harness.load_generator(run.traffic["generator"], run.base)
        self.pool = gen.make_pool(run.traffic, anchors, run.seed, self.device)
        self.batch = run.traffic["batch"]

    def build_model(self):
        from lyft3d_tpu_torch.models.second.voxelnet import VoxelNet

        model = VoxelNet(self.vcfg, in_features=self.in_features, dtype=self.dtype, device=self.device)
        self.served = make_weights(model, self.run.seed, self.device)
        return model

    # ----------------------------------------------------------- counting
    def pool_work(self, indices) -> dict:
        """Operations (forward, the whole model) and the sparse middle's least
        seconds for the pool batches ``indices`` (repeats count again), from
        the reference's voxels and unit sets of each sample."""
        w = ref_weights(self.served)
        per = {}
        for i in set(indices):
            flops, middle_s = 0.0, 0.0
            for b in range(self.batch):
                batch = self.pool[i]
                with torch.no_grad():
                    vox = ref.voxelize_batch(self.rcfg, batch["points"][b : b + 1], batch["points_valid"][b : b + 1])
                    record = [] if self.rcfg.sparse else None
                    if record is not None:
                        feats = ref.encode(self.rcfg, w, vox["voxels"], vox["num_points"], vox["coords"])
                        ref.unit_middle(self.rcfg, w, feats, vox["coords"], vox["voxel_valid"], record=record)
                layers = sparse_middle.layer_work(record, self.rcfg) if record is not None else []
                flops += voxelnet_counts.forward_flops(self.rcfg, self.in_features,
                                                       int(vox["voxel_valid"].sum()), layers)
                middle_s += sparse_middle.least_seconds(layers)
            per[i] = (flops, middle_s)
        return {"flops": sum(per[i][0] for i in indices), "middle_least_s": sum(per[i][1] for i in indices)}


class SecondInfer(SecondCell):
    """Closed loop, one batch in flight: ``infer`` then ``to_host`` a call."""

    entry = "infer"
    span_names = ("encoder.forward", "middle.forward", "rpn.forward", "predict")

    def setup(self):
        from lyft3d_tpu_torch.pipelines import second as second_mod
        from lyft3d_tpu_torch.pipelines.bev import to_host

        self.second_mod = second_mod
        self.to_host = to_host
        self.model = self.build_model()
        self.infer = second_mod.make_second_infer_fn(self.model, self.vcfg)
        # The compared sweeps, drawn from the seed: one from each of
        # ``check_sweeps`` equal stretches of a batch's positions, each in a
        # call drawn among the window's first ``check_from_calls``.
        wl = self.run.workload
        rng = random.Random(self.run.seed)
        n = wl["check_sweeps"]
        if not 1 <= n <= self.batch:
            raise ValueError("check_sweeps must lie between 1 and the batch")
        self.sampled: Dict[int, List[int]] = {}
        for j in range(n):
            lo, hi = j * self.batch // n, (j + 1) * self.batch // n
            self.sampled.setdefault(rng.randrange(wl["check_from_calls"]), []).append(rng.randrange(lo, hi))
        self.min_calls = max(self.sampled) + 1
        self.captured: Dict[int, dict] = {}
        self.detections: Dict[int, dict] = {}
        self.current = -1
        self.fault_hooks()  # planted faults act inside the program, before the capture
        self.model.register_forward_hook(self._capture)
        for i in range(wl["warmup_calls"]):
            batch = self.pool[i % len(self.pool)]
            self.to_host(self.infer(batch["points"], batch["points_valid"]))

    def _capture(self, mod, args, out):
        rows = self.sampled.get(self.current)
        if rows is not None:
            idx = torch.tensor(rows, device=out["box"].device)
            self.captured[self.current] = {k: v.detach()[idx].clone() for k, v in out.items()}

    def fault_hooks(self):
        fault = self.run.fault
        if fault == "half_batch":
            def drop(mod, args, out):
                half = out["box"].shape[0] // 2
                return {k: torch.cat([v[:half], torch.zeros_like(v[half:])]) for k, v in out.items()}
            self.model.register_forward_hook(drop)
        elif fault == "altered_answer":
            predict = self.second_mod.voxelnet_predict

            def altered(*args, **kwargs):
                det = predict(*args, **kwargs)
                first = det["valid"].float().argmax(-1)  # each sample's first valid detection
                rows = torch.arange(first.shape[0], device=first.device)
                det["scores"] = det["scores"].clone()
                det["scores"][rows, first] += 1e-3
                return det
            self.second_mod.voxelnet_predict = altered
            self.restore = lambda: setattr(self.second_mod, "voxelnet_predict", predict)
        elif fault is not None:
            raise ValueError(f"the infer entry has no fault {fault!r}")

    def call(self, i: int) -> int:
        self.current = i
        batch = self.pool[i % len(self.pool)]
        det = self.to_host(self.infer(batch["points"], batch["points_valid"]))
        rows = self.sampled.get(i)
        if rows is not None:
            self.detections[i] = {k: v[rows] for k, v in det.items()}
        return self.batch

    def drain(self):
        pass

    def install_spans(self, spans):
        spans.module("encoder", self.model.encoder)
        if self.model.middle is not None:
            spans.module("middle", self.model.middle)
        spans.module("rpn", self.model.rpn)
        spans.wrap(self.second_mod, "voxelnet_predict", "predict")

    def release(self):
        getattr(self, "restore", lambda: None)()
        del self.model, self.infer
        _free()

    def check(self, calls: int, quant=None) -> List[harness.Check]:
        """The window's sampled sweeps against the reference: the heads from
        points and weights (``maps_gap``) and predict on the program's own
        heads (``detection_mismatches``). ``quant``: the control's
        ``(trunk, heads)`` rounding, run in the program's place."""
        w = ref_weights(self.served)
        anchors = ref.make_anchors(self.rcfg, self.device)
        gap, mismatches, ties, heads = 0.0, 0, 0, {}
        for i, rows in self.sampled.items():
            batch = self.pool[i % len(self.pool)]
            for j, b in enumerate(rows):
                with torch.no_grad():
                    vox = ref.voxelize_batch(self.rcfg, batch["points"][b : b + 1], batch["points_valid"][b : b + 1])
                    want = {k: v[0] for k, v in ref.forward(self.rcfg, w, vox).items()}
                    if quant is None:
                        got = {k: v[j].float() for k, v in self.captured[i].items()}
                        det = {k: v[j] for k, v in self.detections[i].items()}
                    else:
                        got = {k: v[0] for k, v in ref.forward(self.rcfg, w, vox, *quant).items()}
                        det = ref.predict_one(self.rcfg, got, anchors)[0]
                    for k in want:
                        heads[k] = max(heads.get(k, 0.0), ref.rms_gap(got[k], want[k]))
                    gap = max(heads.values())
                    own, near_ties = ref.predict_one(self.rcfg, got, anchors, program=det)
                    ties += near_ties
                    mismatches += ref.detection_mismatches(det, own)
        self.details = {"heads": heads, "near_tie_decisions": ties}
        lim = self.run.workload["limits"]
        return [
            harness.Check("maps_gap", gap, lim["maps_gap"],
                          f"rms gap of the heads to the float32 reference over their spread, worst head of {sum(map(len, self.sampled.values()))} sampled sweeps"),
            harness.Check("detection_mismatches", mismatches, lim["detection_mismatches"],
                          f"slots where predict on the program's heads differs from the reference's ({ties} decisions at IoUs within {ref.NMS_TIE} of the threshold took the program's)"),
        ]


class SecondTrain(SecondCell):
    """``Trainer.step_fn`` on the pool's batches; set-up drives its first
    steps, which the reference follows."""

    entry = "train"
    span_names = ("encoder.forward", "middle.forward", "middle.backward", "rpn.forward", "voxelize",
                  "assign_targets")
    first_steps = 3

    def setup(self):
        from lyft3d_tpu_torch.pipelines import second_train as st
        from lyft3d_tpu_torch.train.optim import build_optimizer
        from lyft3d_tpu_torch.train.trainer import Trainer, TrainerConfig

        self.st = st
        e = self.doc["experiment"]
        opt = e["optimizer"]
        self.model = st.batch_stats_as_parameters(self.build_model())
        self.model_dir = tempfile.TemporaryDirectory(prefix="h100bench-trainer-")
        tcfg = TrainerConfig(model_dir=self.model_dir.name, total_steps=opt["total_steps"],
                             log_every=10 ** 9, eval_every=0, ckpt_every=0)
        self.trainer = Trainer(
            self.model,
            lambda params: build_optimizer(params, opt["name"], opt["lr"], total_steps=opt["total_steps"],
                                           weight_decay=opt["weight_decay"], clip_norm=opt["clip_norm"],
                                           grad_accum=opt["grad_accum"]),
            st.make_second_loss_fn(self.vcfg, self.device), tcfg)
        self.state = self.trainer.init_or_resume()
        self.names = [n for n, p in self.model.named_parameters() if p.requires_grad]
        self.fault_hooks()
        p0 = {n: m.detach().clone() for n, m in zip(self.names, self.state.masters)}
        self.losses = []
        self.step_heads: List[Dict[str, torch.Tensor]] = []  # the first step's, then the window's first
        hook = self.model.register_forward_hook(self._capture)
        for s in range(self.first_steps):
            self.state, metrics = self.trainer.step_fn(self.state, self.pool[s])
            hook.remove()
            self.losses.append({k: float(metrics[k]) for k in ("loss", "cls_loss", "loc_loss", "dir_loss")})
            if s == 0:
                b1 = self.state.optimizer.b1(0)
                wd = opt["weight_decay"]
                slots = self.state.optimizer.state
                self.grad_norms = {
                    n: float(torch.linalg.vector_norm(slots[m]["mu"] / (1.0 - b1) - wd * p0[n]))
                    if "mu" in slots.get(m, {}) else 0.0
                    for n, m in zip(self.names, self.state.masters)}
        self.step_norms = {n: float(torch.linalg.vector_norm(m.detach() - p0[n]))
                           for n, m in zip(self.names, self.state.masters)}
        del p0
        self.window_loss = None
        self.window_hook = self.model.register_forward_hook(self._capture)

    def _capture(self, mod, args, out):
        """A step's heads, as the training forward produced them."""
        self.step_heads.append({k: v.detach().float().clone() for k, v in out.items()})

    def fault_hooks(self):
        fault = self.run.fault
        if fault == "half_batch":  # the forward, the targets and the loss over the first half
            loss_fn = self.trainer.loss_fn

            def half(model, batch, generator=None):
                h = batch["points"].shape[0] // 2
                return loss_fn(model, {k: v[:h] for k, v in batch.items()}, generator)
            self.trainer.loss_fn = half
        elif fault == "half_loss":  # the forward over the whole batch, targets and loss over its first half
            from lyft3d_tpu_torch.models.second.voxelnet import voxelnet_loss

            targets_fn = self.st.make_second_targets_fn(self.vcfg, self.device)

            def half_loss(model, batch, generator=None):
                vox, tgts = targets_fn(batch)
                preds = model(vox["voxels"], vox["num_points"], vox["coords"], vox["voxel_valid"])
                h = batch["points"].shape[0] // 2
                return voxelnet_loss({k: v[:h] for k, v in preds.items()}, {k: v[:h] for k, v in tgts.items()},
                                     self.vcfg)
            self.trainer.loss_fn = half_loss
        elif fault == "unchanged_state":
            self.state.optimizer.step = lambda closure=None: None
        elif fault is not None:
            raise ValueError(f"the train entry has no fault {fault!r}")

    def call(self, i: int) -> int:
        self.state, metrics = self.trainer.step_fn(self.state, self.pool[(i + self.first_steps) % len(self.pool)])
        if i == 0:  # the window's first step is compared too
            self.window_hook.remove()
            self.window_loss = metrics["loss"]
        return self.batch

    def drain(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def install_spans(self, spans):
        spans.module("encoder", self.model.encoder)
        if self.model.middle is not None:
            spans.module("middle", self.model.middle)
            spans.backward("middle", self.model.middle, lambda out: out[0])
        spans.module("rpn", self.model.rpn)
        spans.wrap(self.st, "voxelize", "voxelize")
        spans.wrap(self.st, "assign_targets", "assign_targets")

    def release(self):
        del self.trainer, self.state, self.model
        self.model_dir.cleanup()
        _free()

    def pool_indices(self, calls: int):
        return [(i + self.first_steps) % len(self.pool) for i in range(calls)]

    def reference_steps(self, quant=None):
        """The reference's first steps from the served weights: ``(losses,
        first gradient norms by leaf, change norms by leaf)``. ``quant``: the
        control's roundings."""
        e = self.doc["experiment"]
        opt = e["optimizer"]
        w = ref_weights(self.served)
        w0 = {k: v.clone() for k, v in w.items()}
        adam = ref.AdamOneCycle(opt["lr"], opt["total_steps"], opt["weight_decay"])
        anchors = ref.make_anchors(self.rcfg, self.device)
        losses, grad_norms, heads = [], {}, []
        for s in range(self.first_steps):
            terms, grads = ref.batch_loss_and_grads(self.rcfg, w, self.pool[s], anchors, *(quant or ()),
                                                    heads=heads if s == 0 else None)
            losses.append(terms)
            if s == 0:
                grad_norms = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
            adam.step(w, grads)
        return losses, grad_norms, {k: float(torch.linalg.vector_norm(w[k] - w0[k])) for k in w}, heads

    def check(self, calls: int, quant=None) -> List[harness.Check]:
        """The first steps against the reference's: the first step's heads
        (``maps_gap``, as inference compares them), each step's loss, the
        first gradient as the optimizer got it (by the median leaf: the worst
        leaf, a norm layer's scale or bias, reads a tenth in bfloat16 on the
        reference itself) and the parameters' change after them (by the worst
        leaf). Leaves whose reference gradient is under a thousandth of the
        median leaf's are left out (their Adam steps are round-off). Then
        ``loss_heads_gap``: the loss that the first step and the window's
        first step reported, against the loss that the reference's targets
        and loss give for that step's own heads, sample by sample."""
        want_l, want_g, want_d, want_h = self.reference_steps()
        per_sample = lambda h: [{k: v[b] for k, v in h.items()} for b in range(h["box"].shape[0])]  # noqa: E731
        if quant is None:
            got_l, got_g, got_d = self.losses, self.grad_norms, self.step_norms
            got_h = per_sample(self.step_heads[0])
            reported = [(0, got_l[0]["loss"], got_h)]
            if self.window_loss is not None:
                reported.append((self.first_steps % len(self.pool), float(self.window_loss),
                                 per_sample(self.step_heads[1])))
        else:
            got_l, got_g, got_d, got_h = self.reference_steps(quant)
            reported = [(0, got_l[0]["loss"], got_h)]
        # A sample the program left out reads 1, the gap of a zero answer.
        maps_gap = max(max(ref.rms_gap(got_h[b][k], want_h[b][k]) for k in want_h[b]) if b < len(got_h) else 1.0
                       for b in range(len(want_h)))
        med = float(np.median(list(want_g.values())))
        keys = [k for k in self.names if want_g[k] >= 1e-3 * med]
        rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)  # noqa: E731
        gaps = [{k: rel(g[k], w[k]) for k in w} for g, w in zip(got_l, want_l)]
        loss_gap = max(x["loss"] for x in gaps)
        dmed = float(np.median([want_d[k] for k in keys]))
        grad_gaps = {k: abs(got_g[k] - want_g[k]) / max(want_g[k], med) for k in keys}
        grad_gap = float(np.median(list(grad_gaps.values())))
        worst_grad_gap, grad_leaf = ref.leaf_gap(got_g, want_g, keys)
        step_gap, step_leaf = ref.leaf_gap(got_d, want_d, keys)
        anchors = ref.make_anchors(self.rcfg, self.device)
        loss_heads = []
        for idx, loss, heads in reported:
            if len(heads) < self.batch:  # samples whose heads the program left out: 1
                loss_heads.append(1.0)
                continue
            want = ref.batch_loss_of_heads(self.rcfg, heads, self.pool[idx], anchors)
            loss_heads.append(abs(loss - want) / max(abs(want), 1e-30))
        self.details = {"loss_gaps": gaps, "losses": got_l, "ref_losses": want_l, "grad_leaf": grad_leaf,
                        "worst_grad_gap": worst_grad_gap, "step_leaf": step_leaf, "grad_leaf_gaps": grad_gaps,
                        "step_leaf_gaps": {k: abs(got_d[k] - want_d[k]) / max(want_d[k], dmed) for k in keys},
                        "loss_heads_gaps": loss_heads}
        lim = self.run.workload["limits"]
        left_out = len(self.names) - len(keys)
        return [
            harness.Check("maps_gap", maps_gap, lim["maps_gap"], "the first step's heads, worst head and sample"),
            harness.Check("loss_gap", loss_gap, lim["loss_gap"], f"worst of the first {self.first_steps} steps' losses"),
            harness.Check("grad_gap", grad_gap, lim["grad_gap"],
                          f"median leaf; worst {worst_grad_gap:.4g} at {grad_leaf}; {left_out} leaves left out"),
            harness.Check("step_gap", step_gap, lim["step_gap"], f"worst leaf {step_leaf}"),
            harness.Check("loss_heads_gap", max(loss_heads), lim["loss_heads_gap"],
                          f"worst of {len(loss_heads)} steps (the first, the window's first)"),
        ]


ENTRIES = {"infer": SecondInfer, "train": SecondTrain}


def work(cell, calls: int) -> dict:
    """The operations and the middle's least seconds of a window's ``calls``."""
    if cell.entry == "infer":
        idx = [i % len(cell.pool) for i in range(calls)]
        out = cell.pool_work(idx)
    else:
        out = cell.pool_work(cell.pool_indices(calls))
        out = {k: 3.0 * v for k, v in out.items()}  # forward + the backward's two products
    return out

