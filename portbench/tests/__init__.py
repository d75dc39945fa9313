"""CPU tests of the benchmark harness (the card-marked ones skip without a
card)."""
