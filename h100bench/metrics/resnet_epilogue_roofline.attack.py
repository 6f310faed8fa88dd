"""resnet_epilogue_roofline.attack: the ResNet post-convolution kernels'
share of their bound in the attack window (percent); see
``metrics/resnet_epilogue_roofline.py``."""

from h100bench.metrics.resnet_epilogue_roofline import read  # noqa: F401
