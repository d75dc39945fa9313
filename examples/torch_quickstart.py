"""Quickstart of the PyTorch port: the public API in ~70 lines.

  PYTHONPATH=src python examples/torch_quickstart.py              # the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu

1. Build a reduced AlphaFold behind the FastFold facade — one object binding
   (AlphaFoldConfig, device, ExecutionPlan) — and run folding inference.
2. Run one training step through the same facade.
3. Serve mixed-plan folding traffic (an oracle-leg canary request beside the
   production-leg request) from the one bound FastFold.
4. Build an assigned LLM arch and generate tokens through the serving engine.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import SMOKE, get_config
from repro_torch.data import protein_batches
from repro_torch.exec import ExecutionPlan, FastFold
from repro_torch.layers.params import tree_map
from repro_torch.models.decoder import init_model
from repro_torch.serving.engine import ServingEngine
from repro_torch.train import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    # --- 1. AlphaFold inference ---------------------------------------------
    print("== AlphaFold (reduced) folding inference ==")
    ff = FastFold(SMOKE, device=args.device, plan=ExecutionPlan())
    params = ff.init(seed=0)
    batch = next(protein_batches(batch=1, n_seq=8, n_res=16,
                                 seed=0)).as_dict()
    out = ff.forward(params, batch)             # recycling included
    print("predicted CA coords:", tuple(out["coords"].shape),
          "distogram:", tuple(out["distogram_logits"].shape))

    # --- 2. one training step ------------------------------------------------
    print("== one AlphaFold training step ==")
    init_state, train_step = make_train_step(ff.loss_fn, base_lr=1e-3)
    state, metrics = train_step(init_state(params), batch,
                                torch.Generator(ff.device).manual_seed(1))
    print({k: round(float(v), 3) for k, v in metrics.items()})

    # --- 3. mixed-plan folding serving ---------------------------------------
    print("== mixed-plan folding requests (production + oracle canary) ==")
    canary_plan = ff.plan.with_kernels(enabled=False)   # plain-version leg
    outs = ff.serve(params, [batch, batch], plans=[None, canary_plan])
    drift = float((outs[0]["coords"].float()
                   - outs[1]["coords"].float()).abs().max())
    print(f"production vs oracle-canary coords drift: {drift:.2e}")

    # --- 4. LLM serving (assigned architecture) ------------------------------
    print("== qwen2 (reduced) serving ==")
    cfg = get_config("qwen2-1.5b", reduced_variant=True)
    lm_params = tree_map(lambda t: t.to(ff.device),
                         init_model(torch.Generator().manual_seed(0), cfg))
    engine = ServingEngine(lm_params, cfg, n_slots=2, max_seq=64,
                           device=ff.device)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, size=(8,))
    req = engine.submit(prompt, max_new_tokens=8, temperature=0.8)
    engine.run()
    print("prompt:", prompt.tolist())
    print("generated:", req.generated)


if __name__ == "__main__":
    main()
