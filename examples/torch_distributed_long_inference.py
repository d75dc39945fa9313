"""Paper Figs 12-13 story on the PyTorch port: Dynamic-Axial-Parallel
distributed inference over long sequences — per-rank activation memory drops
~linearly with the DAP degree, which is what lets FastFold fold >3k-residue
proteins that run out of memory on one device.

Runs the DAP Evoformer stack on 1, 2 and 4 gloo ranks (one process each,
``core.dist.run_ranks``), on the card unless given ``--device cpu``; on one
card the ranks share it:

  PYTHONPATH=src python examples/torch_distributed_long_inference.py --n-res 96
  PYTHONPATH=src python examples/torch_distributed_long_inference.py \\
      --device cpu --n-res 32

Each rank's peak is the memory its run held above what it held before: on
the card the allocator's ``max_memory_allocated`` after a warm-up run, on
the CPU the live bytes ``roofline.analysis.counting(memory=True)``
records.
"""
import argparse
import time

import torch

from repro_torch.configs.alphafold import EvoformerConfig
from repro_torch.core import dist as D
from repro_torch.core.dap import dap_evoformer_stack, shard_dap_inputs
from repro_torch.core.evoformer import init_evoformer_stack
from repro_torch.device import resolve_device
from repro_torch.layers.params import tree_map
from repro_torch.roofline.analysis import counting

CFG = EvoformerConfig(d_msa=64, d_pair=32, msa_heads=4, pair_heads=2,
                      head_dim=16, opm_dim=16, tri_mult_dim=32, n_blocks=2)
B, S = 1, 8


def rank_run(rank, world, init_file, n_res, device):
    """One rank: the stack's forward on its shards, bf16; (peak bytes,
    seconds)."""
    dev = D.form_group(rank, world, init_file, backend="gloo", device=device)
    params = tree_map(lambda t: t.to(dev, torch.bfloat16),
                      init_evoformer_stack(torch.Generator().manual_seed(0),
                                           CFG))
    g = torch.Generator().manual_seed(1)
    msa = torch.randn((B, S, n_res, CFG.d_msa), generator=g)
    pair = torch.randn((B, n_res, n_res, CFG.d_pair), generator=g)
    masks = (torch.ones(B, S, n_res), torch.ones(B, n_res),
             torch.ones(B, n_res, n_res))
    args = shard_dap_inputs(None, msa.to(dev, torch.bfloat16),
                            pair.to(dev, torch.bfloat16),
                            *(m.to(dev) for m in masks))
    fn = dap_evoformer_stack(None, CFG, remat=False)
    with torch.no_grad():
        if dev.type == "cuda":
            # Warm-up: what the process allocates once (cuBLAS's 32 MiB
            # workspace) is not the stack's.
            fn(params, *args)
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            before = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        if dev.type == "cuda":
            fn(params, *args)
            torch.cuda.synchronize(dev)
            peak = torch.cuda.max_memory_allocated(dev) - before
        else:
            with counting(memory=True, exclude=(params, args)) as c:
                fn(params, *args)
            peak = int(c.live_bytes().peak)
        return peak, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-res", type=int, default=96)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, or 'cpu')")
    args = ap.parse_args(argv)
    device = resolve_device(args.device).type
    print("DAP distributed inference — per-rank memory vs DAP degree")
    for n in (1, 2, 4):
        for rank, (peak, secs) in enumerate(D.run_ranks(
                rank_run, n, args.n_res, device, timeout_s=600)):
            print(f"ranks={n} rank={rank} n_res={args.n_res} "
                  f"per-rank peak activation bytes={peak:,} "
                  f"wall={secs:.2f}s")


if __name__ == "__main__":
    main()
