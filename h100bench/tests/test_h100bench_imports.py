"""What a run loads: no JAX, no Flax, no JAX package anywhere; and the
plain reference nothing of the port either. Module names are compared by
their top-level part, whole (the port's name begins with the JAX
package's)."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BANNED = {"jax", "jaxlib", "flax", "dl_attack_on_imagenet_tpu"}


def loaded_after(code: str) -> set:
    script = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n{code}\n"
              "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         check=True, timeout=300)
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    names = [p.stem for p in (ROOT / "h100bench" / "metrics").glob("*.py")]
    top = loaded_after(
        "import importlib\n"
        "from h100bench import harness, calibrate, count_flops, program\n"
        "from h100bench.jobs import learn, attack\n"
        f"for n in {names!r}: harness.load_metric(harness.BENCH_DIR, n)")
    assert "dl_attack_on_imagenet_tpu_torch" in top and "torch" in top
    assert not top & BANNED


def test_reference_loads_nothing_of_the_port():
    top = loaded_after(
        "from h100bench.reference import plain, resnet, vit, learn, supervised, unsupervised\n"
        "from h100bench import arith, inputs")
    assert not top & (BANNED | {"dl_attack_on_imagenet_tpu_torch"})
