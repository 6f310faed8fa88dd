"""Benchmark of the PyTorch/CUDA port ``dl_attack_on_imagenet_tpu_torch``
on one NVIDIA H100: dictionary learning and attack throughput. See
``run.py`` for the command and ``harness.py`` for how a run goes."""
