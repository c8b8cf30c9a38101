"""Ordered-growth scaling probe: ms/group-position at 90..4096 groups.

Slope-timed: (wall(3K) - wall(K)) / 2K cancels the fixed per-chain
dispatch and fetch cost. Run on the GPU (default) or CPU:

    python scripts/ordered_scale_probe.py
    JAX_PLATFORMS=cpu python scripts/ordered_scale_probe.py 131072
"""

import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def main():
    n_items_pad = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 20
    from panacus_jax.ops.engine import (
        _ordered_growth_all,
        _put_like,
        ordered_block_for,
    )

    dev = jax.devices()[0]
    print(f"device: {dev.platform} ({dev})", flush=True)
    rng = np.random.default_rng(3)

    def chain(M, w, thr, c_min, k, n_blocks):
        """k dependent ordered-growth passes (weights vary per iteration to
        defeat loop-invariant hoisting)."""
        r = None
        for i in range(k):
            r = _ordered_growth_all(M, w + jnp.int32(i % 2), thr, c_min, n_blocks)
        return np.asarray(r)

    for G in (90, 512, 1024, 4096):
        n_words = (G + 31) // 32
        M = jax.device_put(
            rng.integers(0, 2**32, size=(n_words, n_items_pad), dtype=np.uint32),
            dev,
        )
        thr_np = np.zeros(G + 1, dtype=np.int32)
        thr_np[0] = np.iinfo(np.int32).max
        for g in range(G):
            thr_np[g + 1] = int(np.ceil((g + 1) * 0.3))
        w = _put_like(np.ones(n_items_pad, dtype=np.int32), M)
        thr = _put_like(thr_np, M)
        n_blocks = max(n_items_pad // ordered_block_for(G), 1)
        chain(M, w, thr, 1, 1, n_blocks)  # compile + warm
        k = 4 if G >= 1024 else 8
        t0 = time.time()
        chain(M, w, thr, 1, k, n_blocks)
        t1 = time.time()
        chain(M, w, thr, 1, 3 * k, n_blocks)
        t2 = time.time()
        per_pass = ((t2 - t1) - (t1 - t0)) / (2 * k)
        print(
            f"G={G:5d}: {per_pass * 1e3:8.2f} ms/pass  "
            f"{per_pass * 1e6 / G:8.2f} us/group-position  "
            f"({n_items_pad} items, B={ordered_block_for(G)}, "
            f"slope-timed k={k})",
            flush=True,
        )


if __name__ == "__main__":
    main()
