"""Attacks on unseen images: ``ADIL.forward`` with a fixed dictionary.

The mix gives ``mode`` (``supervised``: DDrague, ``steps_inference``
steps; ``unsupervised``: best of ``trials`` draws) and ``batch``. Set-up
draws D from the seed (U(-1, 1), inside the l∞ constraint set) and saves
it as the dictionary artifact the ``ADIL`` loads, as a trained one would
be. A unit is one batch of fresh seeded images on the card; its work is
the images attacked.

The check takes the window's last batch and one of its first three, drawn
from the seed, and attacks the same images with the plain reference: DDrague
from the same D, or the same draws (``ADIL``'s c-th call of seed s draws
from a generator seeded s·1,000,003 + c; the warm-up batch is call 1). A
supervised cell also runs one more batch once the window has closed, every
victim pass recorded, and judges it from its own passes
(``reference.supervised.replay``); its window's sampled batch has its first
step's pass recorded, judged the same way
(``reference.supervised.first_step``).
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
from torch.profiler import record_function

from .. import inputs, program
from ..harness import Tape, lower_precision, on_device
from ..reference import supervised, unsupervised

CALL_STRIDE = 1_000_003
REPLAY = ("logit_gap", "grad_gap", "solver_gap")


def setup(run) -> SimpleNamespace:
    cfg, mix, dev = run.config, run.mix, run.device
    params = inputs.weights(cfg, run.seed, dev)
    params = {k: v.cpu() for k, v in params.items()}  # handed over as a checkpoint is
    cache = program.ArtifactCache(run.workdir)
    cache.save({"d": inputs.dictionary(run.seed, cfg["attack"]["n_atoms"], cfg["input_size"], dev)},
               program.PREFIX, model=cfg["name"])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)  # from here on, the program's own
    victim = program.victim(cfg, params, dev)
    seed = inputs.sub_seed(run.seed, "adil", bits=31)
    adil = program.adil(victim, cfg, mix, cache, seed, attack=mix["mode"],
                        steps_inference=mix.get("steps_inference", 30),
                        trials=mix.get("trials", 10))
    st = SimpleNamespace(run=run, adil=adil, victim=victim, net=victim.net, seed=seed,
                         params=params,
                         labels=torch.zeros(mix["batch"], dtype=torch.long, device=dev),
                         sample=inputs.sub_seed(run.seed, "sample") % 3, calls=0, units=0,
                         kept=[], first=None, last=None,
                         record_first=(mix["mode"] == "supervised"
                                       and bool(set(REPLAY) & set(run.wanted))))
    st.last = attack(st, "warm-up", record=st.record_first)  # also warms the pinned buffers
    st.first = None
    return st


def batch(st, tag) -> torch.Tensor:
    cfg = st.run.config
    with record_function("bench/images"):
        return inputs.images(st.run.seed, f"batch:{tag}", st.run.mix["batch"], cfg["input_size"],
                             st.run.device)


def attack(st, tag, record: bool = False) -> tuple:
    """One batch through ``ADIL.forward``: (its tag, the call's number, the
    adversaries). With ``record``, the batch's first step pass is kept in
    ``st.first`` as (tag, its record), in pinned host memory."""
    x = batch(st, tag)
    st.calls += 1
    tape = Tape(st.victim, limit=1, only_grad=True, host=True) if record else None
    with record_function("bench/forward"):
        adv = st.adil.forward(x, st.labels)
    if tape is not None:
        tape.close()
        st.first = (tag, tape.records[0])
    return tag, st.calls, adv


def unit(st, i: int) -> None:
    st.last = attack(st, i, record=st.record_first and i == st.sample)
    if i == st.sample:  # kept on the host, so that the card's peak is the program's
        tag, call, adv = st.last
        st.kept.append((tag, call, adv.cpu()))
    st.units = i + 1


def work(st) -> dict:
    return {"attack_images_per_s": st.units * st.run.mix["batch"]}


def reference(st, tag, call: int, model) -> dict:
    """The plain attack of the batch ``tag``, the ADIL's call ``call``."""
    cfg, mix, dev = st.run.config, st.run.mix, st.run.device
    x = batch(st, tag)
    d = inputs.dictionary(st.run.seed, cfg["attack"]["n_atoms"], cfg["input_size"], dev)
    if mix["mode"] == "supervised":
        return dict(x=x, adv=supervised.ddrague(model, d, x, cfg["attack"], mix["steps_inference"]))
    g = torch.Generator(device=dev).manual_seed(st.seed * CALL_STRIDE + call)
    out = unsupervised.trials(model, d, x, g, cfg["attack"], mix["trials"])
    out.update(x=x, adv=out["advs"][out["keep"], torch.arange(x.shape[0], device=dev)])
    return out


def reference_model(st):
    cfg = st.run.config
    return inputs.architecture(cfg).model({k: v.to(st.run.device) for k, v in st.params.items()}, cfg)


def checked_batch(st) -> tuple:
    """One more supervised batch once the window has closed, every victim
    pass recorded: ((tag, call, adversaries), the passes)."""
    tape = Tape(st.victim)
    done = attack(st, "check")
    tape.close()
    return done, tape.records


def answers(st) -> list:
    """The checked window batches' (tag, call, adversaries), the program
    freed."""
    dev = st.run.device
    got = [(tag, call, adv.to(dev)) for tag, call, adv in st.kept if tag != st.last[0]]
    got.append(st.last)
    st.adil = st.victim = st.net = st.kept = st.last = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return got


def replay(st, done: tuple, records: list, model) -> dict:
    """The recorded batch judged from its own passes
    (``reference.supervised.replay``)."""
    cfg, mix = st.run.config, st.run.mix
    tag, _, adv = done
    d = inputs.dictionary(st.run.seed, cfg["attack"]["n_atoms"], cfg["input_size"], st.run.device)
    return supervised.replay(records, model, d, batch(st, tag), adv, cfg["attack"],
                             mix["steps_inference"])


def worst(readings: list) -> dict:
    return {k: max(r[k] for r in readings) for k in readings[0]}


def window_first_step(st, model) -> list:
    """The first step of the window's sampled batch, judged from its
    recorded pass (``reference.supervised.first_step``); none where the
    window closed before that batch (one of its first three) ran."""
    if st.first is None:
        return []
    tag, rec = st.first
    rec = on_device([rec], st.run.device)[0]
    return [supervised.first_step(rec, model, batch(st, tag), st.run.config["attack"])]


def check(st, wanted) -> dict:
    """The numbers that ``wanted`` names: those of the window's answers
    against the plain attack, and those of the steps of one more batch
    replayed from its own passes, with the first step of the window's
    sampled batch, each computed only where one of its numbers is wanted."""
    extra = checked_batch(st) if set(REPLAY) & set(wanted) else None
    got = answers(st)
    model = reference_model(st)
    out = {}
    if set(wanted) - set(REPLAY):
        out.update(worst([compare(adv, reference(st, tag, call, model), st.run)
                          for tag, call, adv in got]))
    if extra:
        out.update(worst([replay(st, *extra, model)] + window_first_step(st, model)))
    return out


def calibrate(st, control: bool) -> dict:
    """The program's readings on one more batch and, with ``control``, the
    plain attack's in TF32 in the program's place."""
    supervised_mode = st.run.mix["mode"] == "supervised"
    if supervised_mode:
        done, records = checked_batch(st)
    else:
        done, records = attack(st, "check"), None
    answers(st)
    model = reference_model(st)
    tag, call, adv = done
    ref = reference(st, tag, call, model)
    out = {"program": compare(adv, ref, st.run)}
    if supervised_mode:
        out["program"].update(replay(st, done, records, model))
    if control:
        tape = Tape()
        with lower_precision():
            low = reference(st, tag, call, tape.wrap(model))
        out["control"] = compare(low["adv"], ref, st.run)
        if supervised_mode:
            out["control"].update(replay(st, (tag, call, low["adv"]), tape.records, model))
    return out


def compare(adv: torch.Tensor, ref: dict, run) -> dict:
    """The numbers compared for one batch.

    Supervised. ``adv_gap``: the largest over the images of the l2 distance
    between the two perturbations (adversary minus image) over the
    reference's. Unsupervised. ``trial_gap``: the largest over the images
    of the l∞ distance from the adversary to the nearest of the
    reference's trial adversaries; ``wrong_picks``: images whose nearest
    trial is not the one the reference keeps, where no decision of the
    image lies within the mix's ``tie_margin`` of its logit gap."""
    mix = run.mix
    if mix["mode"] == "supervised":
        dp, dr = (adv - ref["x"]).flatten(1), (ref["adv"] - ref["x"]).flatten(1)
        rel = torch.linalg.vector_norm(dp - dr, dim=1) / torch.linalg.vector_norm(dr, dim=1)
        return {"adv_gap": float(rel.max())}
    dist = torch.stack([(adv - a).abs().flatten(1).amax(dim=1) for a in ref["advs"]])
    nearest = dist.argmin(dim=0)
    tied = (ref["margins"].abs() < mix["tie_margin"]).any(dim=0)
    wrong = (nearest != ref["keep"]) & ~tied
    return {"trial_gap": float(dist.min(dim=0).values.max()), "wrong_picks": int(wrong.sum())}
