"""End-to-end training with the PyTorch port: an AlphaFold-family model on
synthetic protein batches for a few hundred steps, with checkpoints and
resume.

  PYTHONPATH=src python examples/torch_train_alphafold_mini.py \\
      --steps 300 --config smoke          # on the card
  PYTHONPATH=src python examples/torch_train_alphafold_mini.py --config mini
  PYTHONPATH=src python examples/torch_train_alphafold_mini.py \\
      --device cpu --steps 4 --ckpt-every 2 --ckpt-dir build/af_mini_ckpt

The loss (masked-MSA + distogram + FAPE) decreases measurably within a few
hundred steps because the synthetic family generator has real co-evolution
signal (``repro_torch/data/synthetic.py``). Checkpoints go through
``repro_torch.train.checkpoint`` every ``--ckpt-every`` steps; rerun the same
command with a larger ``--steps`` and it resumes from the newest intact one
("resumed from ... at step k"), taking the batches and dropout masks a run
that never stopped would have taken.

The arguments are the reference example's, plus ``--device`` and those of
the trainer this drives, ``scripts/torch_train_alphafold.py`` (``--trace``,
``--remat-policy``, ``--config full``).
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))

from torch_train_alphafold import main  # noqa: E402

if __name__ == "__main__":
    main()
