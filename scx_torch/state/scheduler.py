"""Phase scheduler (port of scx.state.scheduler) — functional mirror of
the reference Scheduler.

The reference runs named systems in 5 phases with by-name dependencies,
executing each topological wave in parallel on the job system
(reference: sc_scheduler.h:12-44, sc_scheduler.cpp:63-125).  Here systems are
pure functions `(state, ctx) -> state`; the topological sort happens once at
finalize() on the host.

FixedUpdate re-runs `fixed_steps` times per tick (sc_scheduler.cpp:63-72).
`compose_tick` keeps scx's masked form: it runs `max_fixed_steps` substeps
and keeps a substep's result only where it is active (`n_fixed_steps` may be
a tensor, so the count never has to reach the host); inactive substeps see
dt = 0.

Per-system millisecond stats (sc_scheduler.cpp:173-193) come from the eager
path (`tick_eager`), which synchronizes the card after each system.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, fields, is_dataclass, replace
from typing import Callable

import torch

from scx_torch.core import log


def _tree_map(fn, new, old):
    """fn over the tensors of two trees of the same structure (dataclasses,
    dicts, lists, tuples; other leaves are taken as scalars)."""
    if is_dataclass(new) and not isinstance(new, type):
        return replace(new, **{f.name: _tree_map(fn, getattr(new, f.name),
                                                 getattr(old, f.name))
                               for f in fields(new)})
    if isinstance(new, dict):
        return {k: _tree_map(fn, new[k], old[k]) for k in new}
    if isinstance(new, (list, tuple)):
        return type(new)(_tree_map(fn, a, b) for a, b in zip(new, old))
    return fn(new, old)


def _tensors(tree):
    if is_dataclass(tree) and not isinstance(tree, type):
        for f in fields(tree):
            yield from _tensors(getattr(tree, f.name))
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


class Phase(enum.IntEnum):
    """Reference sc_scheduler.h:12-20."""

    INPUT = 0
    SIMULATION = 1
    FIXED_UPDATE = 2
    RENDER_PREP = 3
    RENDER = 4


@dataclass
class SystemDesc:
    name: str
    phase: Phase
    fn: Callable  # (state, ctx) -> state
    deps: tuple = ()


@dataclass
class FixedStepClock:
    """Host-side fixed-timestep accumulator (reference main.cpp:267-308):
    60 Hz, <=4 substeps per frame, accumulator clamped; paused => one zero-dt
    step (so systems still tick)."""

    fixed_dt: float = 1.0 / 60.0
    max_substeps: int = 4
    accumulator: float = 0.0
    paused: bool = False

    def advance(self, frame_dt: float) -> int:
        if self.paused:
            return 1  # one zero-dt step; caller passes dt=0
        self.accumulator = min(
            self.accumulator + frame_dt, self.fixed_dt * self.max_substeps
        )
        steps = 0
        while self.accumulator >= self.fixed_dt and steps < self.max_substeps:
            self.accumulator -= self.fixed_dt
            steps += 1
        return steps


class Scheduler:
    """Ordered composition of pure systems with by-name dependencies."""

    def __init__(self):
        self._systems: list[SystemDesc] = []
        self._finalized: list[list[SystemDesc]] | None = None  # per-phase order
        self.stats_ms: dict[str, float] = {}

    def add_system(self, name, phase, fn, deps=()):
        if any(s.name == name for s in self._systems):
            raise ValueError(f"duplicate system name: {name}")
        self._systems.append(SystemDesc(name, Phase(phase), fn, tuple(deps)))
        return self

    def finalize(self):
        """Topologically order each phase (Kahn); on an unsatisfiable graph,
        fall back to insertion order with a warning (sc_scheduler.cpp:98-110)."""
        per_phase: list[list[SystemDesc]] = [[] for _ in Phase]
        for phase in Phase:
            systems = [s for s in self._systems if s.phase == phase]
            names = {s.name for s in systems}
            remaining = list(systems)
            done: set[str] = set()
            ordered: list[SystemDesc] = []
            stalled = False
            while remaining:
                wave = [
                    s
                    for s in remaining
                    if all((d not in names) or (d in done) for d in s.deps)
                ]
                if not wave:
                    log.warn(
                        "scheduler: unsatisfiable deps in phase %s; "
                        "falling back to insertion order",
                        phase.name,
                    )
                    ordered.extend(remaining)
                    stalled = True
                    break
                for s in wave:
                    ordered.append(s)
                    done.add(s.name)
                remaining = [s for s in remaining if s.name not in done]
                if stalled:
                    break
            per_phase[phase] = ordered
        self._finalized = per_phase
        return self

    def phase_systems(self, phase: Phase) -> list[SystemDesc]:
        assert self._finalized is not None, "call finalize() first"
        return self._finalized[phase]

    # ------------------------------------------------------------------
    # Composition into pure functions (for jit)
    # ------------------------------------------------------------------

    def compose_phase(self, phase: Phase) -> Callable:
        systems = self.phase_systems(phase)

        def run(state, ctx):
            for s in systems:
                state = s.fn(state, ctx)
            return state

        return run

    def compose_tick(self, max_fixed_steps: int = 4) -> Callable:
        """One full tick as a pure function.

        ctx is a dict carrying dt, fixed_dt, n_fixed_steps (an int or an
        i32 tensor), inputs, and any baked world tables. FixedUpdate runs
        `max_fixed_steps` substeps, masking steps beyond n_fixed_steps
        (their result is dropped, and they see dt = 0).
        """
        run_input = self.compose_phase(Phase.INPUT)
        run_sim = self.compose_phase(Phase.SIMULATION)
        run_fixed = self.compose_phase(Phase.FIXED_UPDATE)
        run_prep = self.compose_phase(Phase.RENDER_PREP)
        run_render = self.compose_phase(Phase.RENDER)

        def tick(state, ctx):
            state = run_input(state, ctx)
            state = run_sim(state, ctx)

            n_steps = ctx.get("n_fixed_steps", max_fixed_steps)
            fixed_dt = torch.as_tensor(ctx["fixed_dt"])
            n_steps = torch.as_tensor(n_steps, device=fixed_dt.device)

            if self.phase_systems(Phase.FIXED_UPDATE):
                for i in range(max_fixed_steps):
                    active = n_steps > i
                    sub_ctx = dict(ctx)
                    sub_ctx["dt"] = torch.where(active, fixed_dt, 0.0)
                    sub_ctx["step_active"] = active
                    new = run_fixed(state, sub_ctx)
                    state = _tree_map(
                        lambda a, b: torch.where(
                            active.to(torch.as_tensor(a).device), a, b), new, state)
            state = run_prep(state, ctx)
            state = run_render(state, ctx)
            return state

        return tick

    # ------------------------------------------------------------------
    # Eager debug path with per-system stats
    # ------------------------------------------------------------------

    def tick_eager(self, state, ctx, fixed_steps: int = 1):
        for phase in (Phase.INPUT, Phase.SIMULATION):
            state = self._run_phase_eager(phase, state, ctx)
        for _ in range(fixed_steps):
            sub_ctx = dict(ctx)
            sub_ctx["dt"] = ctx["fixed_dt"]
            state = self._run_phase_eager(Phase.FIXED_UPDATE, state, sub_ctx)
        for phase in (Phase.RENDER_PREP, Phase.RENDER):
            state = self._run_phase_eager(phase, state, ctx)
        return state

    def _run_phase_eager(self, phase, state, ctx):
        for s in self.phase_systems(phase):
            t0 = time.perf_counter()
            state = s.fn(state, ctx)
            if any(t.is_cuda for t in _tensors(state)):
                torch.cuda.synchronize()
            self.stats_ms[s.name] = (time.perf_counter() - t0) * 1e3
        return state
