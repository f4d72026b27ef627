"""The benchmark's generator of LCQP fleets, driven by a configuration's
``problem`` block and a traffic mix, and seeded by ``--seed``.

A fleet is the base instances of the configuration's problem family,
drawn on the host in float64, tiled over the lanes, each instance on the
same number of lanes, in an order drawn from the seed; and, for every
call, the family's draw of that call's per-lane inputs (``g``, and a start
``x0`` where the family gives one), made on the device from ``(seed, call
index)``.  Every seed solves the same set of instances, so the seed changes
the draws and the order and not the amount of work; the same seed gives
the same inputs.

A family is a file, ``families/<family>.py``, found by the ``family`` key
of the ``problem`` block; adding one adds a file and edits none.  It gives

* ``FIELDS``: the LCQP fields it sets (keywords of the program's
  ``make_lcqp``; the rest keep their defaults);
* ``instances(problem)``: name -> (K, ...) float64 NumPy array, one row
  per base instance, for each name of ``FIELDS``;
* ``draw(fleet, call)``: ``{"g": (lanes, nV) float64 tensor}`` and
  optionally ``"x0"`` beside it, on ``fleet.device``, drawn with
  ``fleet.generator(call)``.

Nothing here imports the program: the reference (:mod:`reference`) reads
the same arrays, and a family keeps its own copy of the program's
generator, so that a change to the program's generators does not move the
yardstick.
"""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path

import numpy as np
import torch

BENCH_DIR = Path(__file__).resolve().parent
#: What a family, a mix or a metric may be named.
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


class SpecError(ValueError):
    """``BENCHMARK.json`` or a file it names is missing or malformed."""


def load_file(kind: str, name, bench_dir: Path = BENCH_DIR):
    """The module ``<kind>/<name>.py`` under ``bench_dir``, loaded from its
    file."""
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise SpecError(f"{kind}: no valid name {name!r}")
    path = Path(bench_dir) / kind / f"{name}.py"
    if not path.exists():
        raise SpecError(f"no {kind} file {path}")
    mod_name = f"bench_{kind}_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _entropy(seed: int, *words: int) -> list[int]:
    """Words of a ``SeedSequence`` for a signed seed of any size."""
    s = int(seed)
    return [abs(s), int(s < 0), *words]


class Fleet:
    """The fleet of one run: base instances (float64, on ``device``), the
    lane-to-instance map, and each call's draw."""

    def __init__(self, problem: dict, lanes: int, seed: int, device,
                 bench_dir: Path = BENCH_DIR):
        self.family = load_file("families", problem.get("family"), bench_dir)
        self.fields = tuple(self.family.FIELDS)
        self.problem = problem
        self.seed = int(seed)
        self.lanes = int(lanes)
        self.device = torch.device(device)
        drawn = self.family.instances(problem)
        if set(drawn) != set(self.fields):
            raise SpecError(f"family {problem['family']!r} gave "
                            f"{sorted(drawn)}, not its FIELDS "
                            f"{sorted(self.fields)}")
        #: name -> (K, ...) float64 tensor on the device.
        self.base = {name: torch.as_tensor(drawn[name], dtype=torch.float64,
                                           device=self.device)
                     for name in self.fields}
        self.nV = self.base["Q"].shape[-1]
        self.nC = self.base["A"].shape[-2] if "A" in self.base else 0
        self.nComp = self.base["L"].shape[-2]
        k = self.base["Q"].shape[0]
        #: (lanes,) base instance of each lane: lane i of ``bench.py``'s
        #: tiling (instance i % k), in the seed's order.
        order = torch.randperm(self.lanes, generator=self._generator(0),
                               device=self.device)
        self.instance = order % k

    def lane(self, name: str) -> torch.Tensor:
        """Field ``name`` of the base instances, one row per lane."""
        return self.base[name].index_select(0, self.instance)

    def draw(self, call: int) -> dict:
        """The inputs of call ``call`` (call 0 warms up): ``g``, and ``x0``
        where the family gives a start."""
        return self.family.draw(self, call)

    def g(self, call: int) -> torch.Tensor:
        """(lanes, nV) float64 ``g`` of call ``call``."""
        return self.draw(call)["g"]

    def generator(self, call: int) -> torch.Generator:
        """The generator on the device of call ``call``'s draw."""
        return self._generator(1, call)

    def _generator(self, *words: int) -> torch.Generator:
        """A generator on the device seeded from the run's seed and
        ``words``."""
        state = np.random.SeedSequence(_entropy(self.seed, *words)) \
            .generate_state(2, np.uint32)
        gen = torch.Generator(device=self.device)
        gen.manual_seed((int(state[0]) << 31) ^ int(state[1]))
        return gen
