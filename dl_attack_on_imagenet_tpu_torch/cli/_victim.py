"""The CLI entry points' victim: registry build, torchvision weights, fold.

Port of ``dl_attack_on_imagenet_tpu/cli/_victim.py``. The victim is built
unfolded, ``--weights`` (a ``torch.save``d torchvision ``state_dict``) is
loaded into it, and then, with ``--fast-victim``, its BatchNorms are folded
(exact for eval-mode victims, ``models/fold.py``). ``--fast-victim`` also
builds the space-to-depth stem where ``models.fast_victim_kwargs`` names it
(the ResNets, DenseNet, GoogLeNet): the same parameters, so ``--weights``
loads into it unchanged. ``--device`` picks the card or the CPU; it
defaults to ``cuda``.

Precision: both CLIs run the victim's convolutions in true fp32, as every
check of the port against the JAX package and every wall in ``PERF.md``
did, and the bf16 dictionary contractions of ``--mixed-precision`` with an
fp32 accumulator: :func:`set_precision` turns off torch's defaults of cuDNN
TF32 and of bf16 split-K reductions.
"""

from __future__ import annotations


def add_victim_args(p) -> None:
    """Add the victim options shared by the CLI entry points."""
    p.add_argument("--weights", default=None,
                   help="path to a torch.save'd torchvision state_dict for the victim. "
                        "Default: random weights from --seed")
    p.add_argument("--fast-victim", action="store_true",
                   help="build the victim with its exact-math fast knobs "
                        "(models.fast_victim_kwargs: stem_s2d, fold_bn)")
    p.add_argument("--device", default="cuda",
                   help="device to run on: cuda (default; raises without one) or cpu")


def set_precision() -> None:
    """Turn off cuDNN TF32 (torch's default is on) and cuBLAS's bf16 split-K
    reductions (``ops.dictionary`` refuses them), and say so."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print("precision: cuDNN convolutions in fp32 (torch.backends.cudnn.allow_tf32 = False), "
          "bf16 products with an fp32 accumulator "
          "(torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False)")


def build_victim(args, dtype=None):
    """The victim of ``args`` (model, seed, input size, weights, fast-victim,
    device), loaded and folded in that order, after :func:`set_precision`.
    ``dtype`` is its compute dtype (``torch.bfloat16``; None is fp32), as
    in the JAX package."""
    import torch

    from ..models import blanket_input_size, create_model, fast_victim_kwargs

    set_precision()
    knobs = fast_victim_kwargs(args.model) if args.fast_victim else {}
    if args.fast_victim and not knobs:
        print(f"warning: --fast-victim has no knobs for '{args.model}'; ignored")
    victim = create_model(args.model, seed=args.seed, device=args.device,
                          stem_s2d=knobs.get("stem_s2d", False),
                          dtype=torch.float32 if dtype is None else dtype,
                          input_size=blanket_input_size(args.model,
                                                        getattr(args, "input_size", None)))
    if args.weights:
        from ..models.convert import load_torch_checkpoint

        victim = load_torch_checkpoint(args.weights, victim)
    if knobs.get("fold_bn"):
        from ..models.fold import fold_victim

        victim = fold_victim(victim)
    return victim
