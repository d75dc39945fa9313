from repro_torch.data.synthetic import (  # noqa: F401
    N_AA, N_MSA_TOK, LMBatch, ProteinBatch, lm_batches, protein_batches)
