"""The CLI entry points' victim: registry build, torchvision weights, fold.

Port of ``dl_attack_on_imagenet_tpu/cli/_victim.py``. The victim is built
unfolded, ``--weights`` (a ``torch.save``d torchvision ``state_dict``) is
loaded into it, and then, with ``--fast-victim``, its BatchNorms are folded
(exact for eval-mode victims, ``models/fold.py``). ``--fast-victim``'s
``stem_s2d`` is a TPU layout of the same stem that the port does not build
(ROADMAP.md queue 1 item 12): it is dropped with a printed line.
``--device`` picks the card or the CPU; it defaults to ``cuda``.
"""

from __future__ import annotations


def add_victim_args(p) -> None:
    """Add the victim options shared by the CLI entry points."""
    p.add_argument("--weights", default=None,
                   help="path to a torch.save'd torchvision state_dict for the victim. "
                        "Default: random weights from --seed")
    p.add_argument("--fast-victim", action="store_true",
                   help="build the victim with its exact-math fast knobs "
                        "(models.fast_victim_kwargs; the port applies fold_bn)")
    p.add_argument("--device", default="cuda",
                   help="device to run on: cuda (default; raises without one) or cpu")


def build_victim(args):
    """The victim of ``args`` (model, seed, input size, weights, fast-victim,
    device), loaded and folded in that order."""
    from ..models import blanket_input_size, create_model, fast_victim_kwargs

    knobs = fast_victim_kwargs(args.model) if args.fast_victim else {}
    if args.fast_victim and not knobs:
        print(f"warning: --fast-victim has no knobs for '{args.model}'; ignored")
    if knobs.pop("stem_s2d", False):
        print("note: --fast-victim's stem_s2d is a TPU layout of the same stem and is not "
              "ported (ROADMAP.md queue 1 item 12); the plain stem is built")
    victim = create_model(args.model, seed=args.seed, device=args.device,
                          input_size=blanket_input_size(args.model,
                                                        getattr(args, "input_size", None)))
    if args.weights:
        from ..models.convert import load_torch_checkpoint

        victim = load_torch_checkpoint(args.weights, victim)
    if knobs.get("fold_bn"):
        from ..models.fold import fold_victim

        victim = fold_victim(victim)
    return victim
