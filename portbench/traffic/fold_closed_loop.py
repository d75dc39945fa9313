"""Folding requests from one client in a closed loop through the port's
service entry (``FastFold.serve``): the next request is sent when the last
returns, each ends in a synchronise, its latency is the host clock from
the call to that synchronise. The window ends on a whole cycle of
``lengths``, so every window holds the same mix.

Workload ``params``: ``lengths`` (the true lengths, cycled in this order);
``buckets`` (each request is padded with masks to the smallest bucket that
holds it); ``n_seq`` (the MSA depth); ``pool_cycles`` (cycles of requests
drawn in set-up, each request its own protein, taken in turn);
``sample`` (requests ``correct`` compares: the longest of the first cycle
and others of it drawn from the seed); ``dist_rows`` (at most this many
distogram rows of a sampled request are kept, drawn from the seed).

``correct`` compares the sampled requests' distogram logits and MSA
logits over their real residues with the fp32 reference's fold of the same
request, and their coordinates with the reference's structure module run
on the request's own Evoformer outputs (the structure module's stage: end
to end, its coordinates amplify the Evoformer's rounding by a factor that
changes from seed to seed).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench.harness.compare import rel_gap
from portbench.harness.program import port_config, synchronize, to_device
from portbench.harness.stats import percentile, rate
from portbench.harness.weights import (SAMPLE, derived_seed, draw_weights,
                                       input_rng)
from portbench.reference.alphafold import AlphaFold, Dims, Precision
from portbench.reference.alphafold import param_shapes
from portbench.reference.synthetic import protein_batch
from portbench.traffic._alphafold import ROW_BYTES, item_work

FEATURES = ("msa", "msa_mask", "residue_index", "aatype", "seq_mask")


class Session:
    def __init__(self, cell):
        self.cell = cell
        self.p = cell.workload["params"]
        self.dims = Dims.from_config(cell.config)
        self.dev = torch.device(cell.device)
        self._work = {}
        self.kept = {}

    def requests(self) -> list:
        """(true length, bucket, features) of every request of the pool."""
        rng = input_rng(self.cell.seed)
        out = []
        for _ in range(self.p["pool_cycles"]):
            for n in self.p["lengths"]:
                bucket = min(b for b in self.p["buckets"] if b >= n)
                feats = protein_batch(rng=rng, batch=1, n_seq=self.p["n_seq"],
                                      n_res=bucket, n_real=n)
                out.append((n, bucket, {k: feats[k] for k in FEATURES}))
        return out

    def choose_sample(self) -> dict:
        """{request number: distogram rows kept} of the first cycle."""
        lengths = self.p["lengths"]
        rng = np.random.default_rng(derived_seed(self.cell.seed, SAMPLE))
        longest = int(np.argmax(lengths))
        others = [i for i in range(len(lengths)) if i != longest]
        picks = [longest] + sorted(int(i) for i in rng.choice(
            others, size=min(len(others), self.p["sample"] - 1),
            replace=False))
        out = {}
        for i in picks:
            n = lengths[i]
            rows = (np.arange(n) if n <= self.p["dist_rows"] else
                    np.sort(rng.choice(n, self.p["dist_rows"], replace=False)))
            out[i] = torch.as_tensor(rows)
        return out

    def weights(self) -> dict:
        return draw_weights(param_shapes(self.dims), self.cell.seed, self.dev,
                            self.cell.config.get("weight_scales"))

    def setup(self) -> None:
        from repro_torch.exec import FastFold

        self.ff = FastFold(port_config(self.cell.config), device=self.dev)
        self.params = self.weights()
        self.pool = [(n, b, to_device(f, self.dev))
                     for n, b, f in self.requests()]
        self.sample = self.choose_sample()
        # Warm-up: one whole request of each bucket the traffic uses.
        warm = {}
        for bucket in sorted({b for _, b, _ in self.pool}):
            batch = next(f for _, b, f in self.pool if b == bucket)
            (warm[bucket],) = self.ff.serve(self.params, [batch])
        # Host buffers, page-locked on a card, for the sampled requests'
        # outputs: the window copies into them at the card's speed (a
        # pageable copy of r = 2048's pair took half a second).
        pin = self.dev.type == "cuda"
        self.kept = {}
        for k, rows in self.sample.items():
            n, bucket, _ = self.pool[k]
            self.kept[k] = {
                name: torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                for name, t in self._outputs(warm[bucket], n, rows).items()}
        del warm
        synchronize(self.dev)
        self.k = 0
        self.filled = set()

    @staticmethod
    def _outputs(out: dict, n: int, rows: torch.Tensor,
                 stage: bool = True) -> dict:
        """The outputs compared, over the ``n`` real residues, where they
        were made; ``stage``: also the structure module's inputs, in the
        dtype they were made."""
        dev = out["distogram_logits"].device
        kept = {"coords": out["coords"][0, :n].float(),
                "msa_logits": out["msa_logits"][0, :, :n].float(),
                "distogram_logits": out["distogram_logits"][
                    0, rows.to(dev), :n].float()}
        if stage:
            kept["msa_first"] = out["msa"][0, 0, :n]
            kept["pair"] = out["pair"][0, :n, :n]
        return kept

    def item(self) -> dict:
        n, bucket, batch = self.pool[self.k % len(self.pool)]
        t0 = time.perf_counter()
        (out,) = self.ff.serve(self.params, [batch])
        synchronize(self.dev)
        done = time.perf_counter()
        if self.k in self.sample:
            bufs = self.kept[self.k]
            for name, t in self._outputs(out, n, self.sample[self.k]).items():
                bufs[name].copy_(t, non_blocking=True)
            self.filled.add(self.k)
        self.k += 1
        return {"work": float(n), "latency_s": done - t0, "done": done,
                "kind": bucket}

    def mid_cycle(self) -> bool:
        """Whether the window is inside a cycle of ``lengths``."""
        return self.k % len(self.p["lengths"]) != 0

    def drain(self) -> None:
        synchronize(self.dev)

    def failed(self, window) -> int:
        return 0

    def end_to_end(self, window) -> dict:
        recs = window.records
        return {"fold_residues_per_s": rate(sum(r["work"] for r in recs),
                                            window.t_start, window.t_done),
                "fold_latency_p90_s": percentile(
                    [r["latency_s"] for r in recs], 90)}

    def work_of(self, bucket: int):
        if bucket not in self._work:
            self._work[bucket] = item_work(self.dims, 1, self.p["n_seq"],
                                           bucket, train=False)
        return self._work[bucket]

    def release(self) -> None:
        self.ff = self.params = self.pool = None

    def reference(self, precision: str, which) -> dict:
        prec = Precision(precision)
        model = AlphaFold(self.dims, prec, row_bytes=ROW_BYTES)
        params = self.weights()
        reqs = self.requests()
        out = {}
        with torch.no_grad(), prec.products():
            for k in which:
                n, _, feats = reqs[k % len(reqs)]
                res = model.forward(params, to_device(feats, self.dev))
                out[k] = {name: t.cpu() for name, t in self._outputs(
                    res, n, self.sample[k], stage=precision != "fp32").items()}
                del res
        return out

    def structure_stage(self, got: dict) -> dict:
        """{request: the fp32 reference's CA coords from the request's own
        Evoformer outputs}."""
        model = AlphaFold(self.dims, row_bytes=ROW_BYTES)
        params = self.weights()
        out = {}
        with torch.no_grad(), model.q.products():
            for k, kept in got.items():
                out[k] = model.structure_stage(
                    params, kept["msa_first"].to(self.dev),
                    kept["pair"].to(self.dev)).cpu()
        return out

    def check(self, control: str | None = None) -> dict:
        which = sorted(self.filled) if not control else sorted(self.sample)
        if not which:
            return {}
        want = self.reference("fp32", which)
        got = (self.reference(control, which) if control else
               {k: self.kept[k] for k in which})
        return compare(got, want, self.structure_stage(got))


def compare(got: dict, want: dict, stage: dict) -> dict:
    """The worst sampled request's relative gap of each output: the logits
    against the reference's fold, the coordinates against the reference's
    structure module on the same Evoformer outputs (``stage``)."""
    out = {name: max(rel_gap(got[k][key], want[k][key]) for k in want)
           for name, key in (("dist_gap", "distogram_logits"),
                             ("msa_gap", "msa_logits"))}
    out["structure_gap"] = max(rel_gap(got[k]["coords"], stage[k])
                               for k in want)
    return out
