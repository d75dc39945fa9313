"""Training steps back to back through the port's step
(``make_train_step(FastFold.loss_fn)``), a new seeded crop each step, no
synchronise between steps.

Workload ``params``: ``n_res``, ``n_seq``, ``batch`` (the crop);
``pool`` (crops drawn in set-up and taken in turn); ``compare_steps``
(the steps of set-up that ``correct`` follows); ``optimizer`` (base_lr,
warmup_steps, total_steps, clip_norm, weight_decay: AdamW's, handed to the
program and to the reference alike); ``exclude_below`` (a leaf whose
first gradient in the reference is under this share of the median leaf's
moves by round-off alone and is left out of the change compared).

``correct`` compares the set-up's steps, which are the window's own call
and feed: each step's loss, each leaf's first gradient norm as AdamW got
it (its first moment over 1 - beta1) and each leaf's change over the
steps, against the fp32 reference from the same weights, crops and
dropout masks.
"""
from __future__ import annotations

import torch

from portbench.harness.compare import leaf_gap
from portbench.harness.program import port_config, synchronize, to_device
from portbench.harness.stats import rate
from portbench.harness.weights import (DROPOUT, derived_seed, draw_weights,
                                       input_rng)
from portbench.reference.alphafold import AlphaFold, Dims, Precision, leaves
from portbench.reference.alphafold import param_shapes
from portbench.reference.synthetic import protein_batch
from portbench.reference.train import train_steps

from portbench.traffic._alphafold import ROW_BYTES, item_work

BETA1 = 0.9     # AdamW's first-moment decay, the program's default


class Session:
    def __init__(self, cell):
        self.cell = cell
        self.p = cell.workload["params"]
        self.dims = Dims.from_config(cell.config)
        self.dev = torch.device(cell.device)
        self._work = None

    def crops(self, n: int) -> list:
        rng = input_rng(self.cell.seed)
        p = self.p
        return [protein_batch(rng=rng, batch=p["batch"], n_seq=p["n_seq"],
                              n_res=p["n_res"]) for _ in range(n)]

    def dropout_generator(self):
        return torch.Generator(device=self.dev).manual_seed(
            derived_seed(self.cell.seed, DROPOUT))

    def weights(self) -> dict:
        return draw_weights(param_shapes(self.dims), self.cell.seed, self.dev,
                            self.cell.config.get("weight_scales"))

    def setup(self) -> None:
        from repro_torch.exec import FastFold
        from repro_torch.train import make_train_step

        ff = FastFold(port_config(self.cell.config), device=self.dev)
        init, self.step = make_train_step(ff.loss_fn, optimizer="adamw",
                                          **self.p["optimizer"])
        self.state = init(self.weights())
        self.gen = self.dropout_generator()
        self.pool = [to_device(b, self.dev)
                     for b in self.crops(self.p["pool"])]
        self.k = 0
        self.skips = []
        p0 = [t.clone() for _, t in leaves(self.state.params)]
        self.losses = []
        for i in range(self.p["compare_steps"]):
            self.state, m = self.step(self.state, self.pool[self.k], self.gen)
            self.k += 1
            self.losses.append(float(m["loss"]))
            if i == 0:
                self.grad_norms = [float(torch.linalg.norm(t)) / (1 - BETA1)
                                   for _, t in leaves(self.state.opt_state.m)]
        self.delta_norms = [float(torch.linalg.norm(p - q)) for (_, p), q
                            in zip(leaves(self.state.params), p0)]
        del p0

    def item(self) -> dict:
        batch = self.pool[self.k % len(self.pool)]
        self.k += 1
        self.state, m = self.step(self.state, batch, self.gen)
        self.skips.append(m["nonfinite_skips"])
        return {"work": float(self.p["batch"]), "kind": "step"}

    def drain(self) -> None:
        synchronize(self.dev)

    def failed(self, window) -> int:
        return int(sum(float(s) for s in self.skips))

    def end_to_end(self, window) -> dict:
        work = sum(r["work"] for r in window.records)
        return {"train_samples_per_s": rate(work, window.t_start,
                                            window.t_done)}

    def work_of(self, kind: str):
        if self._work is None:
            p = self.p
            self._work = item_work(self.dims, p["batch"], p["n_seq"],
                                   p["n_res"], train=True)
        return self._work

    def release(self) -> None:
        self.state = self.step = self.pool = self.gen = None

    def reference(self, precision: str) -> dict:
        prec = Precision(precision)
        model = AlphaFold(self.dims, prec, row_bytes=ROW_BYTES)
        params = self.weights()
        batches = [to_device(b, self.dev)
                   for b in self.crops(self.p["compare_steps"])]
        with prec.products():
            return train_steps(model, params, batches,
                               self.dropout_generator(), self.p["optimizer"])

    def check(self, control: str | None = None) -> dict:
        want = self.reference("fp32")
        got = (self.reference(control) if control else
               {"losses": self.losses, "grad_norms": self.grad_norms,
                "delta_norms": self.delta_norms})
        return compare(got, want, self.p["exclude_below"])


def compare(got: dict, want: dict, exclude_below: float) -> dict:
    """The three numbers: the worst step's relative loss gap, the worst
    leaf's gap of first-gradient norms and of changes."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(got["losses"], want["losses"]))
    g = want["grad_norms"]
    med = sorted(g)[len(g) // 2]
    moved = [x >= exclude_below * med for x in g]
    return {"loss_gap": loss_gap,
            "grad_gap": leaf_gap(got["grad_norms"], g),
            "delta_gap": leaf_gap(got["delta_norms"], want["delta_norms"],
                                  keep=moved)}
