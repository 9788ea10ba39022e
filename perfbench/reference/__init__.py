"""The plain reference the benchmark judges the program by: float32 PyTorch,
written from the models' and the method's published description. It
imports nothing of the program and takes nothing the program made."""
