"""Training steps of the fp32 model: loss, gradients by autograd (each
Evoformer block checkpointed), the global-norm clip, the scheduled rate and
AdamW, over the same batches and dropout generator as the program's."""
from __future__ import annotations

import torch

from portbench.reference.alphafold import (AlphaFold, alphafold_loss,
                                           draw_dropout_keeps, leaves,
                                           rebuild)
from portbench.reference.optim import adamw, clip, lr_at


def train_steps(model: AlphaFold, params: dict, batches: list, generator,
                hp: dict) -> dict:
    """Run one step per batch from ``params``. Returns each step's
    ``losses``, the first step's clipped gradient norms per leaf
    (``grad_norms``, in ``leaves`` order) and each leaf's change after the
    last step (``delta_norms``)."""
    p0 = [t.detach() for _, t in leaves(params)]
    p = [t.clone() for t in p0]
    m = [torch.zeros_like(t) for t in p]
    v = [torch.zeros_like(t) for t in p]
    losses, grad_norms = [], None
    for step, batch in enumerate(batches):
        live = [t.detach().requires_grad_(True) for t in p]
        keeps = draw_dropout_keeps(model.d, tuple(batch["msa"].shape),
                                   generator, batch["msa"].device)
        out = model.forward(rebuild(params, live), batch, keeps=keeps,
                            train=True, remat=True)
        loss = alphafold_loss(out, batch)
        del out
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads, live)]
        grads, _ = clip(grads, hp["clip_norm"])
        lr = lr_at(step, hp["base_lr"], hp["warmup_steps"], hp["total_steps"])
        p, m, v = adamw(p, grads, m, v, step + 1, lr,
                        weight_decay=hp["weight_decay"])
        losses.append(float(loss.detach()))
        if grad_norms is None:
            grad_norms = [float(torch.linalg.norm(g)) for g in grads]
        del live, grads, loss
    delta = [float(torch.linalg.norm(a - b)) for a, b in zip(p, p0)]
    return {"losses": losses, "grad_norms": grad_norms, "delta_norms": delta}
