#!/usr/bin/env python
"""Device time of the coverage-histogram forms XLA compiles, on the GPU,
beside the ordered-growth scan and the similarity products.

    python scripts/hist_forms_probe.py

Histogram forms, each a popcount over M's group words plus a weighted
bincount of the per-item coverage:
  scatter  an int32 scatter-add of every item into n_bins bins;
  blocked  per item block, an int32 compare-and-sum against every bin that
           XLA fuses into one reduction, then a sum over blocks;
  rows     the engine's form (ops.engine.fused_hist_scatter): per block of
           HIST_BLOCK items, a scatter-add into the block's own row of bins
           (contention spread over blocks x bins), then a sum over rows.
Shapes: the seeded chr22 graph's node and edge matrices (90 groups) and a
1 GiB M (1024 groups x 8.4M items). Each call runs REPS times inside a
jax.profiler trace; the time is the mean device duration of the call's XLA
module, and the rate its M bytes over that time, as a share of the card's
HBM bandwidth from the table below. A device kind not in the table is an
error. Prints one line per measurement and a JSON summary as the last line.
"""

from __future__ import annotations

import glob
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from bench import card_info

# HBM bytes/s by jax device_kind (NVIDIA H100 SXM data sheet: 3.35 TB/s)
HBM_PEAK = {"NVIDIA H100 80GB HBM3": 3.35e12}

BLOCK = 4096
REPS = 20


def hist_blocked(M, w, n_bins: int):
    import jax
    import jax.numpy as jnp

    n = M.shape[1]
    cov = jnp.sum(
        jax.lax.population_count(M).astype(jnp.int32), axis=0, dtype=jnp.int32
    ).reshape(n // BLOCK, BLOCK, 1)
    bins = jax.lax.broadcasted_iota(jnp.int32, (1, 1, n_bins), 2)
    wb = w.astype(jnp.int32).reshape(n // BLOCK, BLOCK, 1)
    part = jnp.sum(jnp.where(cov == bins, wb, 0), axis=1, dtype=jnp.int32)
    return jnp.sum(part, axis=0, dtype=jnp.int32)


def hist_scatter(M, w, n_bins: int):
    import jax
    import jax.numpy as jnp

    cov = jnp.sum(
        jax.lax.population_count(M).astype(jnp.int32), axis=0, dtype=jnp.int32
    )
    return jnp.zeros(n_bins, jnp.int32).at[cov].add(
        w.astype(jnp.int32), mode="drop"
    )


def device_times(trace_dir: str):
    """{(line name, event name): total device ns} over the GPU planes of
    the newest trace under trace_dir."""
    from jax.profiler import ProfileData

    path = sorted(
        glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True),
        key=os.path.getmtime,
    )[-1]
    out = {}
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                k = (line.name, ev.name)
                out[k] = out.get(k, 0.0) + ev.duration_ns
    return out


def traced(fn, args, reps: int, trace_root: str, tag: str):
    """(mean device ns per call of jitted fn — the summed durations of the
    events on the GPU's stream lines, or on its "XLA Modules" line where
    the trace has one; mean host-clock s per call with the profiler off)."""
    import jax

    jax.block_until_ready(fn(*args))  # compile + warm
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(fn(*args))
    wall = (time.perf_counter() - t0) / reps
    d = tempfile.mkdtemp(prefix=tag + "-", dir=trace_root)
    jax.profiler.start_trace(d)
    for _ in range(reps):
        jax.block_until_ready(fn(*args))
    jax.profiler.stop_trace()
    times = device_times(d)
    modules = {k: v for k, v in times.items() if k[0] == "XLA Modules"}
    if not modules:  # no module line: every event on the device's streams
        modules = {k: v for k, v in times.items() if k[0].startswith("Stream")}
    top = sorted(times.items(), key=lambda kv: -kv[1])[:6]
    for (line, name), ns in top:
        print(f"    [{tag}] {line} | {name[:70]}: {ns / reps / 1e3:.1f} us/call")
    return sum(modules.values()) / reps, wall


def main() -> None:
    import jax
    import jax.numpy as jnp

    from panacus_jax.ops import engine

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, default device is {dev.platform}")
    card = card_info()
    print(f"card: {card}; jax device_kind {dev.device_kind}")
    trace_root = tempfile.mkdtemp(prefix="hist-forms-")

    scatter = jax.jit(hist_scatter, static_argnums=(2,))
    blocked = jax.jit(hist_blocked, static_argnums=(2,))
    shapes = [
        # (name, n_words, n_items, n_groups, max weight)
        ("chr22-node", 3, 901120, 90, 16),
        ("chr22-edge", 3, 3604480, 90, 1),
        ("1GiB", 32, 1 << 23, 1024, 255),
    ]
    results = {}
    for name, n_words, n_items, n_groups, w_max in shapes:
        n_bins = n_groups + 2
        k1, k2 = jax.random.split(jax.random.PRNGKey(0))
        M = jax.random.bits(k1, (n_words, n_items), jnp.uint32)
        if n_groups % 32:
            M = M.at[-1].set(M[-1] & jnp.uint32((1 << (n_groups % 32)) - 1))
        w = jax.random.randint(k2, (n_items,), 0, w_max + 1, dtype=jnp.int32)
        forms = (
            ("scatter", scatter),
            ("blocked", blocked),
            ("rows", engine.fused_hist_scatter),
        )
        ref = np.asarray(scatter(M, w, n_bins))
        for form, fn in forms[1:]:
            got = np.asarray(fn(M, w, n_bins))
            assert np.array_equal(ref, got), f"{name}: {form} disagrees"
        for form, fn in forms:
            ns, wall = traced(
                lambda M, w, fn=fn: fn(M, w, n_bins),
                (M, w),
                REPS,
                trace_root,
                f"{name}-{form}",
            )
            gbps = M.nbytes / ns if ns else None
            results[f"{name}/{form}"] = {
                "device_us": ns / 1e3,
                "wall_us": wall * 1e6,
                "gbps": gbps,
            }
            print(
                f"{name} {form}: M {M.nbytes / 1e6:.1f} MB, {n_bins} bins: "
                f"{ns / 1e3:.1f} us/call device ({gbps} GB/s), "
                f"{wall * 1e6:.1f} us/call host clock",
                flush=True,
            )
    # the group programs at the chr22 node shape (90 groups)
    M = jax.random.bits(jax.random.PRNGKey(1), (3, 901120), jnp.uint32)
    M = M.at[-1].set(M[-1] & jnp.uint32((1 << 26) - 1))
    thr = np.zeros(91, dtype=np.int32)
    thr[0] = np.iinfo(np.int32).max
    w = jnp.ones(901120, jnp.int32)
    n_blocks = 901120 // engine.ordered_block_for(90)
    for name, fn, fargs in (
        (
            "ordered",
            lambda M, w, thr: engine._ordered_growth_all(M, w, thr, 1, n_blocks),
            (M, w, jnp.asarray(thr)),
        ),
        (
            "similarity",
            lambda M, w: engine._sim_all(M, w, 901120 // engine.SIM_BLOCK),
            (M, w),
        ),
    ):
        ns, wall = traced(fn, fargs, REPS, trace_root, name)
        results[f"chr22-node/{name}"] = {
            "device_us": ns / 1e3,
            "wall_us": wall * 1e6,
        }
        print(
            f"chr22-node {name}, 90 groups: {ns / 1e3:.1f} us/call device, "
            f"{wall * 1e6:.1f} us/call host clock",
            flush=True,
        )

    peak = HBM_PEAK.get(dev.device_kind)
    summary = {"card": card, "device_kind": dev.device_kind, "results": results}
    if peak is None:
        print(json.dumps(summary))
        raise SystemExit(f"no HBM peak for device kind {dev.device_kind!r}")
    for k, r in results.items():
        if r.get("gbps"):
            r["share_of_hbm_peak"] = r["gbps"] * 1e9 / peak
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
