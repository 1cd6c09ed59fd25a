"""The plain reference the benchmark judges the program by: float32
PyTorch with TF32 off, no kernels, no cache, no batching tricks, built
from the model's numbers in the configuration file and the benchmark's
own weight draws.  Nothing here imports the program."""
