"""The plain reference of the benchmark: float32 PyTorch and NumPy that
import nothing of the measured program."""
