"""The pile fleet (configs/pile64.json): bench.py's pile scenes made on the
card from the seed, stepped through `scx_torch.physics.fleet.rollout`.

Traffic (traffic/pile64.<mix>.json): `envs` (how many scenes a user steps
at once), `route` ("fused": `planar.step_planar_cached`, which must take
its fused route; "staged": `planar.step_planar_staged`), `chunk_steps`
(steps per `rollout` call in the window: the host reads nothing between
calls), `warm_steps` and `traced_steps`.

The benchmark makes the raw scenes (positions, sizes, which body is
static); the program builds its bodies from them with its own
`make_bodies`, the reference works out its own constants from them. Three
steps are kept whole, each a `rollout` call of one step whose input is
kept: the first of set-up, which starts from the raw scenes, and the first
and last of the window. The check holds each against the plain reference
(reference/pile64.py), every env."""

from __future__ import annotations

import time

import torch

from portbench.reference import pile64 as ref
from portbench.run import Window

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2^32 for uint32 values held in int64 and a constant c."""
    return ((((x * (c >> 16)) & _M32) << 16) + x * (c & 0xFFFF)) & _M32


def mix32(x):
    """The lowbias32 hash of bench.py's scenes (sc_world_partition.cpp)."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def rand01(state):
    """One draw of bench.py's uniform stream: (next state, value in [0, 1] f32)."""
    state = mix32((state + 0x6D2B79F5) & _M32)
    return state, (state & 0xFFFFFF).to(torch.float32) / 16777215.0


def scenes(cfg: dict, envs: int, seed: int, device):
    """Raw [envs, bodies] pile scenes on `device`, as bench.py's build_batch
    makes them with `seed` in place of its world seed 1337: (positions
    [E, N, 3] f32, half extents [E, N, 3] f32, dynamic [E, N] bool). Body i
    of env e draws from mix32(coord_seed(seed, e, 0) + i * stride)."""
    n, d = int(cfg["bodies"]), cfg["drop"]
    e = torch.arange(envs, device=device)
    h = torch.full_like(e, seed & _M32) ^ mix32(_mul32(e, 73856093)) ^ mix32(torch.zeros_like(e))
    env_seed = mix32((h + 0x9E3779B9) & _M32)
    i = torch.arange(n, device=device)
    s = mix32((env_seed[:, None] + _mul32(i, int(d["body_stride"]))) & _M32)
    s, rx = rand01(s)
    s, ry = rand01(s)
    _, rz = rand01(s)
    pos = torch.stack([(rx - 0.5) * d["x_span"], d["y_low"] + ry * d["y_span"],
                       (rz - 0.5) * d["z_span"]], -1)
    pos[:, 0] = torch.tensor(cfg["slab"]["pos"], device=device)
    size = torch.tensor(cfg["box_half_extents"], device=device).repeat(envs, n, 1)
    size[:, 0] = torch.tensor(cfg["slab"]["half_extents"], device=device)
    dynamic = torch.ones((envs, n), dtype=torch.bool, device=device)
    dynamic[:, 0] = False
    return pos.contiguous(), size.contiguous(), dynamic


def program_bodies(cfg: dict, pos, size, dynamic):
    """The program's bodies of the raw scenes, by its own `make_bodies` with
    the configuration's body constants."""
    from scx_torch.physics import planar
    from scx_torch.physics.rigid import BODY_DYNAMIC, BODY_STATIC, make_bodies

    b = cfg["body"]
    full = lambda v, dt=torch.float32: torch.full(dynamic.shape, v, dtype=dt, device=pos.device)
    bodies = make_bodies(
        pos, size=size, mass=full(b["mass"]),
        body_type=torch.where(dynamic, BODY_DYNAMIC, BODY_STATIC).to(torch.int32),
        friction=full(b["friction"]), restitution=full(b["restitution"]),
        lin_damping=full(b["lin_damping"]), ang_damping=full(b["ang_damping"]),
        layer=torch.where(dynamic, b["layer_dynamic"], b["layer_static"]).long(),
        mask=torch.where(dynamic, b["mask_dynamic"], b["mask_static"]).long())
    return planar.map_tensors(lambda t: t.contiguous(), planar.planar_from_rigid(bodies))


def solver_params(cfg: dict):
    """The program's SolverParams of the configuration."""
    from scx_torch.physics.solver import SolverParams

    s, st = cfg["solver"], cfg["step"]
    keys = ("gravity", "dt", "baumgarte", "slop", "restitution_threshold", "relaxation",
            "warm_start", "sleep_lin", "sleep_ang", "sleep_time")
    return SolverParams(max_pairs=int(s["max_pairs"]), iterations=int(s["iterations"]),
                        shape_kinds=tuple(s["shape_kinds"]), **{k: st[k] for k in keys})


class Pile:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, log, dump=None):
        from scx_torch.physics import fleet, planar

        t = time.perf_counter()
        self.cfg, self.device, self.log, self.seed, self.dump = cfg, device, log, seed, dump
        self.envs, self.route = int(traffic["envs"]), traffic["route"]
        self.chunk = int(traffic["chunk_steps"])
        self.traced_steps = int(traffic["traced_steps"])
        self.params = solver_params(cfg)
        self.fleet, self.planar = fleet, planar
        self.step_fn = {"fused": planar.step_planar_cached,
                        "staged": planar.step_planar_staged}[self.route]
        pos, size, self.dynamic = scenes(cfg, self.envs, seed, device)
        self.statics = ref.statics(cfg, size, self.dynamic)
        self.bodies = program_bodies(cfg, pos, size, self.dynamic)
        self.cache = planar.empty_planar_cache(self.envs, self.params.max_pairs, device=device)
        self._sync()
        built = time.perf_counter()
        self.routes0 = dict(planar.STEP_ROUTES)
        self.launches0 = self._launches()
        self.samples = []
        self._kept_step(torch.zeros((), dtype=torch.int64, device=device))
        self.bodies, self.cache, _ = self._rollout(self.bodies, self.cache,
                                                   int(traffic["warm_steps"]) - 1)
        self._sync()
        self.setup_parts = {"inputs_s": built - t, "warm_s": time.perf_counter() - built}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _launches(self) -> dict:
        p = self.planar
        return {"middle": p.MIDDLE_KERNEL_LAUNCHES, "sat": p.SAT_KERNEL_LAUNCHES,
                "solve": p.SOLVE_KERNEL_LAUNCHES}

    def _rollout(self, b, c, steps):
        return self.fleet.rollout(b, c, self.params, steps, step_fn=self.step_fn)

    def _kept_step(self, bad):
        """One `rollout` call of one step, its input and output kept."""
        pre = (self.bodies, self.cache)
        self.bodies, self.cache, ovf = self._rollout(*pre, 1)
        self.samples.append((pre, (self.bodies, self.cache)))
        return bad + (ovf > 0).to(torch.int64)

    def window(self, seconds: float) -> Window:
        bad = torch.zeros((), dtype=torch.int64, device=self.device)  # steps that overflowed
        self._sync()
        t0 = time.perf_counter()
        bad, steps = self._kept_step(bad), 1
        while time.perf_counter() - t0 < seconds:
            self.bodies, self.cache, ovf = self._rollout(self.bodies, self.cache, self.chunk)
            bad = bad + (ovf > 0).to(torch.int64) * self.chunk
            steps += self.chunk
        bad, steps = self._kept_step(bad), steps + 1
        failed = int(bad) * self.envs  # a host read, after the last step
        self._sync()
        elapsed = time.perf_counter() - t0
        self.log(f"window {steps} fleet steps of {self.envs} envs in {elapsed:.4f} s")
        return Window(env_steps=steps * self.envs, seconds=elapsed, failed=failed)

    def run_traced(self):
        from portbench.trace import STEP

        with torch.profiler.record_function(STEP):
            self.bodies, self.cache, _ = self._rollout(self.bodies, self.cache,
                                                       self.traced_steps - 1)
        self.probe_pre = (self.bodies, self.cache)
        with torch.profiler.record_function(STEP):
            self.bodies, self.cache, _ = self._rollout(self.bodies, self.cache, 1)

    def probe(self, block: int = 2048) -> dict:
        """The work of the traced stretch's last step, as the roofline
        readers (portbench/bounds.py) count it: the fleet's shape, the pairs,
        the bodies in pairs and the pairs with a contact, by the reference on
        the state that step started from, and the reference's operations in
        its narrowphase, solve set-up and sweeps, scaled to the pairs
        (narrowphase) and to the contacts (solve) that exist."""
        from portbench import bounds

        pre = ref.from_program(*self.probe_pre)
        w = {"envs": self.envs, "bodies": pre.pos.shape[1], "slots": self.params.max_pairs,
             "pairs": 0, "pair_bodies": 0, "live_pairs": 0, "contacts": 0,
             "narrow_ops": 0.0, "setup_ops": 0.0, "sweep_ops": 0.0}
        for i in range(0, self.envs, block):
            cut = lambda x: type(x)(**{k: v[i:i + block] for k, v in x.__dict__.items()})
            c = ref.front(cut(pre), cut(self.statics), self.cfg)
            ops = [bounds.count_ops(lambda: ref.narrow(c)), bounds.count_ops(lambda: ref.setup(c)),
                   bounds.count_ops(lambda: ref.sweeps(c))]
            pv = c["ia"] >= 0
            slots, cslots = pv.numel(), c["valid"].numel()
            used = torch.zeros(c["pos"].shape[:2], dtype=torch.long, device=pv.device)
            used.scatter_add_(1, c["ga"], pv.long()).scatter_add_(1, c["gb"], pv.long())
            n_pv, n_c = int(pv.sum()), int(c["valid"].sum())
            w["pairs"] += n_pv
            w["pair_bodies"] += int((used > 0).sum())
            w["live_pairs"] += int(c["valid"].any(-1).sum())
            w["contacts"] += n_c
            w["narrow_ops"] += ops[0] * n_pv / slots
            w["setup_ops"] += ops[1] * n_c / cslots
            w["sweep_ops"] += ops[2] * n_c / cslots
        return {"route": self.route, "work": w}

    def check(self) -> dict:
        """The numbers the cell's limits name (reference/pile64.py), the
        route's counters beside them."""
        routes = {k: v - self.routes0[k] for k, v in self.planar.STEP_ROUTES.items()}
        launches = {k: v - self.launches0[k] for k, v in self._launches().items()}
        expect = {"fused": {"fused"}, "staged": set()}[self.route]
        off_route = sum(v for k, v in routes.items() if k not in expect)
        kernels = {"fused": {"middle"}, "staged": {"sat", "solve"}}[self.route]
        off_route += sum(v for k, v in launches.items() if k not in kernels)
        if self.device.type == "cuda":  # on the CPU every wrapper runs its plain version
            off_route += sum(1 for k in kernels if launches[k] == 0)
        self.log(f"routes {routes} kernel launches {launches}")
        samples, self.samples = self.samples, []
        self.bodies = self.cache = self.probe_pre = None  # the program's state goes
        rows, ambiguous, reach = [], [], []
        start = ref.static_err(ref.program_statics(samples[0][0][0]), self.statics)
        for k, (pre, got) in enumerate(samples):
            pre, got = ref.from_program(*pre), ref.from_program(*got)
            out, amb, shaky = ref.step_blocks(pre, self.statics, self.cfg)
            rows.append(ref.readings(got, out, amb, shaky, self.dynamic))
            ambiguous.append(float(amb.float().mean()))
            reach.append(float(ref.tainted(got, out, shaky, self.dynamic).float().mean()))
            if self.dump and (rows[-1]["deep_flip_envs"] or rows[-1]["vel_err"] > 1e-4
                              or rows[-1]["lam_err"] > 1e-4):
                self._dump(k, pre, got, out, amb, shaky)
            del pre, got, out
        self.log(f"share of envs with a decision too close to call, by kept step: {ambiguous}; "
                 f"share of bodies not compared: {reach}")
        return {**ref.worst(rows), "static_err": start, "off_route": float(off_route)}

    def _dump(self, k, pre, got, out, amb, shaky):
        """The envs of kept step k whose discrete results differ from the
        reference's with no decision too close to call, or whose compared
        bodies differ the most, written to <dump>/<seed>.<k>.pt with what the
        reference needs to step them again."""
        far = (got.vel - out.vel).abs().amax(-1) * ~ref.tainted(got, out, shaky, self.dynamic)
        envs = torch.cat([(ref.discrete_mismatch(got, out, self.dynamic) & ~amb).nonzero()[:, 0][:6],
                          far.amax(1).topk(2).indices])
        part = lambda x: {n: v[envs].cpu() for n, v in x.__dict__.items()}
        torch.save({"envs": envs.cpu(), "pre": part(pre), "got": part(got),
                    "statics": part(self.statics)}, f"{self.dump}/{self.seed}.{k}.pt")
        self.log(f"dumped envs {envs.tolist()} of kept step {k}")

    def control(self) -> dict:
        """The control's numbers on the same kept steps: the reference in
        bfloat16, from the same states and constants rounded to bfloat16."""
        rows = []
        low = ref.Statics(**{k: (v.to(torch.bfloat16) if v.is_floating_point() else v)
                             for k, v in self.statics.__dict__.items()})
        for pre, _ in self.samples:
            pre = ref.from_program(*pre)
            out, amb, shaky = ref.step_blocks(pre, self.statics, self.cfg)
            ctl, _, _ = ref.step_blocks(pre, low, self.cfg, dtype=torch.bfloat16)
            rows.append(ref.readings(ctl, out, amb, shaky, self.dynamic))
        start = ref.static_err({k: v for k, v in low.__dict__.items() if k != "dynamic"},
                               self.statics)
        return {**ref.worst(rows), "static_err": start}


def setup(cfg: dict, traffic: dict, seed: int, device, log=print, shared=None) -> Pile:
    return Pile(cfg, traffic, seed, device, log, dump=(shared or {}).get("dump"))
