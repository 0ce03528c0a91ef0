"""The plain reference of a DIGEST training cell, in plain PyTorch and
NumPy.  It imports nothing of the program: it works out the adjacency,
the partition and every epoch again from the generated inputs."""
