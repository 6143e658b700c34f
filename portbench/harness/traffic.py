"""The benchmark's traffic: a mix is a JSON file of parameters under
``traffic/``, and its ``kind`` names the generator that reads it,
``generators/<kind>.py``.  A generator's ``make_pool(mix, config, seed,
data_dir)`` turns the mix, the configuration and ``--seed`` into a pool of
distinct cases, in whatever form the configuration's entry takes; a new
kind of traffic is a new generator file, and a new mix of a known kind a
new data file.

Every case of a mix has the same sizes, so a seed changes the data and not
the amount of work.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from portbench.harness import spec

SEED_MASK = (1 << 64) - 1


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator drawn from ``seed`` (any whole number) and ``stream``."""
    return np.random.default_rng(np.random.SeedSequence([seed & SEED_MASK, *stream]))


def generator(kind: str, bench_dir: Path = spec.BENCH_DIR):
    """The module ``generators/<kind>.py``."""
    return spec.load_module(bench_dir / "generators" / f"{kind}.py")


def make_pool(mix: dict, config: dict, seed: int, data_dir: Path):
    """The pool of cases of ``mix`` for ``config`` and ``seed``, made by the
    mix's generator (found beside ``data_dir``)."""
    return generator(mix["kind"], Path(data_dir).parent).make_pool(mix, config, seed, data_dir)
