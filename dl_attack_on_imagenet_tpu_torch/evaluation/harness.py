"""Hyper-parameter grids, performance measurement, selection, transfer.

Port of ``dl_attack_on_imagenet_tpu/evaluation/harness.py``: ``expand_grid``
takes any number of swept variables, and ``get_performance`` names every
attack. Batches move to the victim's device; each metric is read back to
the host once a batch, as the JAX package does.
"""

from __future__ import annotations

import inspect
import itertools
import time
from typing import Any, Dict, Iterable, List, Sequence

import numpy as np
import torch

from ..models import VictimModel
from .metrics import compute_fooling_rate, compute_mse, compute_rmse


def expand_grid(*args) -> List[Dict[str, Any]]:
    """('name1', values1, 'name2', values2, ...) -> the list of kwargs dicts
    of their full cartesian product."""
    if len(args) % 2 != 0:
        raise ValueError("expand_grid expects (name, values) pairs")
    names, values = args[0::2], args[1::2]
    if not names:
        return [dict()]
    return [dict(zip(names, combo)) for combo in itertools.product(*values)]


def get_atks(victim: VictimModel, attack_cls, *grid_args, **kwargs) -> list:
    """One attack per hyper-combo; each records its swept combo on
    ``_grid_combo``, which :func:`_attack_key` puts into its name."""
    atks = []
    for combo in expand_grid(*grid_args):
        atk = attack_cls(victim, **{**kwargs, **combo})
        atk._grid_combo = dict(combo)
        atks.append(atk)
    return atks


def _to_device(victim: VictimModel, x, y):
    dev = victim.device
    return (torch.as_tensor(x, dtype=torch.float32, device=dev),
            torch.as_tensor(y, device=dev))


def performance(attack, victim: VictimModel, data: Iterable, verbose: bool = False):
    """Fooling rate, RMSE and MSE over batches, on the rows the victim
    classifies correctly.

    The kept rows are padded back to the batch size by cycling them before
    the attack is called, as the JAX package does (there to keep one
    compiled shape); the padding also decides the unsupervised draws, which
    depend on the batch shape, so it is kept for equal numbers. Metrics use
    only the real rows. An attack that would learn lazily on its first call
    learns here first, on the real kept rows, so that the cycled duplicates
    never enter training: ADIL and ADILR through ``learn_dictionary``,
    UAP-PGD and Fast-UAP through ``learn_attack``.
    """
    num_samples = 0
    fooling = rmse = mse = 0.0
    for x, y in data:
        x, y = _to_device(victim, x, y)
        with torch.no_grad():
            pre = victim.predict(x)
        keep = pre == y
        k = int(keep.sum())
        if k == 0:
            continue
        b = x.shape[0]
        xk, yk = x[keep], y[keep]
        if k < b:
            if getattr(attack, "is_trained", True) is False:
                kept = (xk.cpu().numpy(), yk.cpu().numpy())
                if hasattr(attack, "learn_dictionary"):
                    # ADIL takes (data_train, data_val), ADILR (data_train):
                    # ask the signature first, since a TypeError caught
                    # around the call would mask one raised in training.
                    n_params = len(inspect.signature(attack.learn_dictionary).parameters)
                    if n_params >= 2:
                        attack.learn_dictionary(kept, None)
                    else:
                        attack.learn_dictionary(kept)
                elif hasattr(attack, "learn_attack"):  # the UAP family
                    attack.learn_attack(kept, None)
            reps = -(-b // k)
            x_in, y_in = torch.cat([xk] * reps)[:b], torch.cat([yk] * reps)[:b]
        else:
            x_in, y_in = xk, yk
        num_samples += k
        adv = attack(x_in, y_in)[:k]
        fooling += compute_fooling_rate(victim, adv, xk, clean_labels=pre[keep])
        rmse += compute_rmse(adv, xk)
        mse += compute_mse(adv, xk)
    denom = max(num_samples, 1)
    return {"fooling_rate": fooling / denom, "rmse": rmse / denom, "mse": mse / denom,
            "num_samples": num_samples}


def _attack_key(name: str, atk) -> str:
    """Sub-name of an attack instance: every hyper its grid swept, then
    whichever of ``n_atoms``, ``loss``, ``eps`` and ``norm`` it has (on
    itself or on its ``cfg``) and the grid did not sweep."""
    extras = [f"{attr}_{val}" for attr, val in getattr(atk, "_grid_combo", {}).items()]
    seen = set(getattr(atk, "_grid_combo", {}))
    for attr in ("n_atoms", "loss", "eps", "norm"):
        if attr in seen:
            continue
        if hasattr(atk, attr):
            extras.append(f"{attr}_{getattr(atk, attr)}")
        elif hasattr(atk, "cfg") and hasattr(atk.cfg, attr):
            extras.append(f"{attr}_{getattr(atk.cfg, attr)}")
    return "_".join([name] + extras) if extras else name


def get_performance(atks: Dict[str, Sequence], victim: VictimModel, data,
                    verbose: bool = False):
    """Run every attack instance over ``data``, timing each.

    As in the JAX package (and the reference), a group's lists land under
    its last instance's sub-name; a key that collides across groups gets a
    ``__<group>`` suffix, and ``group_key`` / ``sub_names`` record the
    group -> key mapping and every instance's own sub-name.
    """
    fooling_rate: Dict[str, list] = {}
    rmse: Dict[str, list] = {}
    mse: Dict[str, list] = {}
    time_cost: Dict[str, list] = {}
    group_key: Dict[str, str] = {}
    sub_names: Dict[str, list] = {}

    for name, instances in atks.items():
        f_tmp, r_tmp, m_tmp, t_tmp, s_tmp = [], [], [], [], []
        sub_name = name
        for atk in instances:
            sub_name = _attack_key(name, atk)
            s_tmp.append(sub_name)
            if verbose:
                print(f"evaluating {sub_name} ...")
            start = time.time()
            perf = performance(atk, victim, data)
            elapsed = time.time() - start
            if verbose:
                print(f"  {elapsed:.1f}s {perf}")
            f_tmp.append(perf["fooling_rate"])
            r_tmp.append(perf["rmse"])
            m_tmp.append(perf["mse"])
            t_tmp.append(elapsed)
        if sub_name in fooling_rate:
            sub_name = f"{sub_name}__{name}"
        fooling_rate[sub_name] = f_tmp
        rmse[sub_name] = r_tmp
        mse[sub_name] = m_tmp
        time_cost[sub_name] = t_tmp
        group_key[name] = sub_name
        sub_names[name] = s_tmp

    return {"fooling_rate": fooling_rate, "rmse": rmse, "mse": mse, "time": time_cost,
            "group_key": group_key, "sub_names": sub_names}


def select_hyperparameter(atks_hyper: Dict[str, Sequence], victim: VictimModel, data,
                          budget: Sequence[float], criterion: str = "mse_limit",
                          verbose: bool = False):
    """Pick, per group and per budget value, the hyper-combo that meets it.

    'rmse' / 'mse': closest to the budget; 'fooling_rate': closest, ties
    broken by the largest rmse; 'mse_limit': the largest fooling rate among
    combos with mse <= budget, ties broken by the largest mse, NaN where
    none qualifies.
    """
    validation_perf = get_performance(atks_hyper, victim, data, verbose=verbose)
    mse = validation_perf["mse"]
    rmse = validation_perf["rmse"]
    fooling_rate = validation_perf["fooling_rate"]
    input_keys = list(atks_hyper.keys())
    keys = [validation_perf["group_key"][name] for name in input_keys]

    atks_selected, perf = [], []
    for budget_val in budget:
        res_atks, res_fool, res_rmse, res_mse = {}, {}, {}, {}
        for in_key, key in zip(input_keys, keys):
            fr = np.asarray(fooling_rate[key], float)
            rm = np.asarray(rmse[key], float)
            ms = np.asarray(mse[key], float)
            ind: Any
            if criterion == "rmse":
                ind = int(np.argmin(np.abs(rm - budget_val)))
            elif criterion == "mse":
                ind = int(np.argmin(np.abs(ms - budget_val)))
            elif criterion == "fooling_rate":
                vmin = np.abs(fr - budget_val)
                cand = np.where(vmin == vmin.min())[0]
                ind = int(cand[np.argmax(rm[cand])])
            elif criterion == "mse_limit":
                admissible = np.where(ms - budget_val <= 0)[0]
                if len(admissible) == 0:
                    ind = None
                else:
                    vfr = fr[admissible]
                    best = admissible[np.where(vfr == vfr.max())[0]]
                    ind = int(best[np.argmax(ms[best])])
            else:
                raise ValueError(f"unknown criterion {criterion}")

            if ind is None:
                res_fool[key] = res_rmse[key] = res_mse[key] = np.nan
                res_atks[key] = []
            else:
                res_fool[key] = fr[ind]
                res_rmse[key] = rm[ind]
                res_mse[key] = ms[ind]
                res_atks[key] = [atks_hyper[in_key][ind]]
        perf.append({"fooling_rate": res_fool, "rmse": res_rmse, "mse": res_mse})
        atks_selected.append(res_atks)

    return atks_selected, perf, validation_perf


def get_transfer_performance(atks: Dict[str, Sequence], victims: Dict[str, VictimModel],
                             data):
    """Cross-model transfer matrix: each group's first attack builds the
    adversaries, and every victim is measured on them."""
    out: Dict[str, dict] = {}
    for name, instances in atks.items():
        if len(instances) == 0:
            out[name] = {v: {"fooling_rate": np.nan, "rmse": np.nan, "mse": np.nan}
                         for v in victims}
            continue
        attack = instances[0]
        perf = {v: {"fooling_rate": 0.0, "rmse": 0.0, "mse": 0.0} for v in victims}
        num_samples = 0
        for x, y in data:
            x, y = _to_device(attack.victim, x, y)
            num_samples += x.shape[0]
            adv = attack(x, y)
            for vname, victim in victims.items():
                perf[vname]["fooling_rate"] += compute_fooling_rate(victim, adv, x)
                perf[vname]["rmse"] += compute_rmse(adv, x)
                perf[vname]["mse"] += compute_mse(adv, x)
        for vname in perf:
            for k in perf[vname]:
                perf[vname][k] /= max(num_samples, 1)
        out[name] = perf
    return out
