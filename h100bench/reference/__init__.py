"""Plain PyTorch references: the victims (one file per architecture) and
the attack's step and solvers (one file per mode).

Nothing here imports the program under test, JAX or the JAX package. Every
function takes its inputs as plain tensors (weights by torchvision's names,
NHWC images in [0, 1], the seed) and works out what the program derives
from them itself: labels, the pseudo-inverse, the projections, the draws.
"""
