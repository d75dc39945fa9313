"""Plain fp32 PyTorch yardstick: the model, its update, its inputs and
the cost arithmetic. Imports nothing of the program."""
