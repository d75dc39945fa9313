from repro_torch.data.synthetic import (  # noqa: F401
    N_AA, N_MSA_TOK, ProteinBatch, protein_batches)
