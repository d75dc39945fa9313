"""AlphaFold model: Evoformer, structure module, embedders and heads."""
