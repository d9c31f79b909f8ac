"""The benchmark of scx_torch, the PyTorch and CUDA port, on NVIDIA H100s.

One command runs one cell of BENCHMARK.json (at the root of the checkout)
once, from the root of the checkout:

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It builds the cell's inputs on the card from the seed, warms every shape
the cell uses (set-up), measures for `--seconds` seconds, checks what the
timed path produced against the plain reference, and prints one JSON line
last on standard output. With `--trace 0` its metrics are the cell's
end-to-end metrics, with `--trace 1` its per-layer metrics, read from a
torch.profiler trace of a few steps after the window.

Everything is found by name, so a cell, a configuration, a traffic mix or a
metric is added by adding files:

- `configs/<config>.json`: the configuration as it is run; `configs/<config>.py`
  builds it and drives the program (`setup(config, traffic, seed, device)`
  returns the system under test: `window`, `traced_steps`, `probe`, `check`).
- `traffic/<cell>.json`: the cell's traffic mix, read by its configuration's
  module.
- `metrics/<metric>.py`: `read(run) -> float | None` for one per-layer metric.
- `reference/<config>.py`: the plain reference, written from the semantics
  and sharing no code with the program; `reference/<cell>.limits.json` the
  limits of the numbers its check compares, with the readings each was set
  from.

`bounds.py` (the roofline arithmetic and the H100's peaks), `trace.py` (the
reduction of a trace to busy time, launches and idle gaps) and `stats.py`
belong to the benchmark too: a later change to the program does not move
them. Nothing here imports jax, jaxlib, flax or scx, the JAX package.
"""
