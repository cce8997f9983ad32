"""Hyperparameter sweeps (the Hydra/Optuna multirun analog).

Port of use_tpu/cli/sweep.py, its samplers copied as they are; the trials
run the port's ``cmd_train`` (on CUDA unless ``device=cpu``). Reference
parity: configs/hparams_search/mnist_optuna.yaml (Optuna TPE multirun) —
sweep a search space over repeated train runs and report the best trial
by the optimized metric. Two samplers over YAML-defined spaces:
`sampler=random` and `sampler=tpe` (a tree-structured Parzen estimator:
after a random warmup, new points are drawn from a KDE over the best
gamma-quantile of past trials and scored by the good/bad density ratio,
per dimension — the algorithm Optuna's TPESampler implements):

    python -m use_tpu_torch.cli.sweep experiment=SGMSE_debug n_trials=8 \
        sampler=tpe metric=val/loss_Score direction=min \
        'space.train.lr=loguniform(1e-5,1e-3)' \
        'space.model.t_eps=uniform(0.01,0.1)' \
        data.clean_json_path=... data.noise_json_path=... [device=cpu]

Each trial writes under runs/sweep/<time>/trial<i>; its value is the
optimized metric of the trial's optimized_metric.json (the best
checkpoint's), its metrics.csv's last row where the record lacks it. The
best trial goes to runs/sweep/<time>/best.json.
"""
from __future__ import annotations

import json
import math
import os
import random
import re
import sys
import time
from typing import Dict, List, Tuple

from use_tpu_torch.utils.logging import ranked_logger

log = ranked_logger()

_SPACE_RE = re.compile(r"(loguniform|uniform|choice)\((.*)\)")


def _parse_space(spec: str) -> Tuple[str, List]:
    m = _SPACE_RE.match(spec.strip())
    if not m:
        raise SystemExit(f"bad space spec {spec!r}")
    kind, args = m.groups()
    vals = [a.strip() for a in args.split(",")]
    if kind in ("uniform", "loguniform"):
        return kind, [float(vals[0]), float(vals[1])]
    return kind, [json_try(v) for v in vals]


def _sample(spec: str, rng: random.Random):
    kind, vals = _parse_space(spec)
    if kind == "uniform":
        return rng.uniform(vals[0], vals[1])
    if kind == "loguniform":
        lo, hi = math.log(vals[0]), math.log(vals[1])
        return math.exp(rng.uniform(lo, hi))
    return rng.choice(vals)


# --- TPE (tree-structured Parzen estimator), per-dimension ----------------

def _kde_logpdf(x: float, centers: List[float], bw: float) -> float:
    """log of a Gaussian mixture with one component per center."""
    if not centers:
        return 0.0
    logs = [-0.5 * ((x - c) / bw) ** 2 - math.log(bw) for c in centers]
    m = max(logs)
    return m + math.log(sum(math.exp(v - m) for v in logs) / len(logs))


def tpe_propose(
    spec: str,
    history: List[Tuple[float, object]],
    rng: random.Random,
    gamma: float = 0.25,
    n_candidates: int = 24,
):
    """Propose one value for a dimension given [(loss, value), ...] history.

    Splits history at the gamma-quantile of the (minimized) objective into
    good/bad sets, draws candidates from a Parzen KDE over the good set and
    returns the candidate maximizing the good/bad density ratio
    (Bergstra et al. 2011, the estimator behind Optuna's TPESampler).
    """
    kind, vals = _parse_space(spec)
    if len(history) < 4:
        return _sample(spec, rng)
    ordered = sorted(history, key=lambda t: t[0])
    n_good = max(1, int(math.ceil(gamma * len(ordered))))
    good = [v for _, v in ordered[:n_good]]
    bad = [v for _, v in ordered[n_good:]]

    if kind == "choice":
        # categorical TPE: smoothed count ratio
        def weight(v):
            g = sum(1 for x in good if x == v) + 1.0
            b = sum(1 for x in bad if x == v) + 1.0
            return (g / (len(good) + len(vals))) / (b / (len(bad) + len(vals)))

        weights = [weight(v) for v in vals]
        total = sum(weights)
        r = rng.uniform(0, total)
        acc = 0.0
        for v, w in zip(vals, weights):
            acc += w
            if r <= acc:
                return v
        return vals[-1]

    to_x = math.log if kind == "loguniform" else (lambda v: v)
    from_x = math.exp if kind == "loguniform" else (lambda v: v)
    lo, hi = (to_x(vals[0]), to_x(vals[1]))
    gx = [to_x(v) for v in good]
    bx = [to_x(v) for v in bad]
    bw = max((hi - lo) / max(len(gx), 1) ** 0.5, 1e-12 + 0.01 * (hi - lo))

    best_x, best_score = None, -math.inf
    for _ in range(n_candidates):
        c = min(max(rng.gauss(rng.choice(gx), bw), lo), hi)
        score = _kde_logpdf(c, gx, bw) - _kde_logpdf(c, bx, bw)
        if score > best_score:
            best_x, best_score = c, score
    # exp(log(lo)) can round just below lo — clamp in the value domain
    return min(max(from_x(best_x), vals[0]), vals[1])


def json_try(v: str):
    try:
        return json.loads(v)
    except json.JSONDecodeError:
        return v


def main(argv: List[str] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    space: Dict[str, str] = {}
    passthrough: List[str] = []
    n_trials, metric, direction, experiment = 4, "val/loss_Score", "min", None
    sampler = "random"
    extras: Dict[str, str] = {}
    for a in argv:
        if a.startswith("space."):
            k, v = a[len("space."):].split("=", 1)
            space[k] = v
        elif a.startswith("n_trials="):
            n_trials = int(a.split("=", 1)[1])
        elif a.startswith("metric="):
            metric = a.split("=", 1)[1]
        elif a.startswith("direction="):
            direction = a.split("=", 1)[1]
        elif a.startswith("sampler="):
            sampler = a.split("=", 1)[1]
            if sampler not in ("random", "tpe"):
                raise SystemExit(f"sampler must be random|tpe, got {sampler!r}")
        elif a.startswith("experiment="):
            experiment = a.split("=", 1)[1]
        elif a.startswith("device="):
            extras["device"] = a.split("=", 1)[1]
        else:
            passthrough.append(a)
    if experiment is None:
        raise SystemExit("experiment=<name> required")
    if not space:
        raise SystemExit("at least one space.<key>=<spec> required")

    from use_tpu_torch.cli.main import cmd_train

    rng = random.Random(0)
    results: List[Tuple[float, Dict]] = []
    sweep_dir = os.path.join("runs", "sweep", time.strftime("%Y%m%d-%H%M%S"))
    for trial in range(n_trials):
        if sampler == "tpe":
            # per-dimension history as (minimized objective, value)
            sign = 1.0 if direction == "min" else -1.0
            sampled = {
                k: tpe_propose(
                    v, [(sign * r, p[k]) for r, p in results], rng
                )
                for k, v in space.items()
            }
        else:
            sampled = {k: _sample(v, rng) for k, v in space.items()}
        overrides = passthrough + [f"{k}={v}" for k, v in sampled.items()]
        out_dir = os.path.join(sweep_dir, f"trial{trial}")
        log.info(f"trial {trial}: {sampled}")
        cmd_train(experiment, overrides, {**extras, "out_dir": out_dir})
        # the optimized metric comes from cmd_train's test-after-fit record
        # (best checkpoint, reference src/train.py:90-108) — a trial whose
        # final epoch regressed still reports its best. The CSV last row is
        # only a fallback for metrics outside the record.
        value = None
        opt_path = os.path.join(out_dir, "optimized_metric.json")
        if os.path.exists(opt_path):
            with open(opt_path) as f:
                rec = json.load(f)
            if rec.get("metric") == metric:
                value = float(rec["value"])
            elif metric in rec.get("test", {}):
                value = float(rec["test"][metric])
            elif metric in rec.get("monitor", {}) and rec["monitor"][metric] is not None:
                value = float(rec["monitor"][metric])
        if value is None:
            import csv

            with open(os.path.join(out_dir, "metrics.csv")) as f:
                rows = list(csv.DictReader(f))
            value = float(rows[-1][metric])
        results.append((value, sampled))
        log.info(f"trial {trial}: {metric}={value:.5g}")

    best = min(results) if direction == "min" else max(results)
    log.info(f"best {metric}={best[0]:.5g} with {best[1]}")
    with open(os.path.join(sweep_dir, "best.json"), "w") as f:
        json.dump({"metric": metric, "value": best[0], "params": best[1]}, f, indent=2)


if __name__ == "__main__":
    import logging

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main()
