"""Subprocess worker for tests/test_multihost.py: joins the JAX
distributed runtime (coordinator env vars set by the launcher), runs the
production GraphBroker on the shared fixture, and writes its process's
results as JSON. Not a pytest module (no test_ prefix)."""

import json
import os
import sys


def main():
    gfa = sys.argv[1]
    out_path = sys.argv[2]
    mode = sys.argv[3] if len(sys.argv) > 3 else "hist"
    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    from panacus_jax.parallel.ingest import init_distributed

    assert init_distributed(), "coordinator env vars missing"
    assert jax.process_count() == int(os.environ["JAX_NUM_PROCESSES"])

    from panacus_jax.broker import GraphBroker, GraphState, Req
    from panacus_jax.config import Grouping
    from panacus_jax.utils import CountType, Threshold
    from panacus_jax.ops.engine import item_mesh_of

    gb = GraphBroker()
    res = {
        "process": jax.process_index(),
        "n_processes": jax.process_count(),
        "n_devices": len(jax.devices()),
    }
    if mode in ("hist", "exclude"):
        reqs = {
            Req.graph(gfa),
            Req.NODE,
            Req.BP,
            Req.HIST,
            Req.PATH_LENS,
        }
        state = GraphState(graph=gfa, name="mh", grouping=Grouping.sample())
        if mode == "exclude":
            state.exclude = sys.argv[4]
            reqs.add(Req.EDGE)
        gb.change_graph_state(state, reqs, nice=False)
        hists = gb.get_hists()
        eng = gb.get_abacus_by_total(CountType.NODE).engine
        mesh = item_mesh_of(eng.M)
        res.update(
            m_sharded=mesh is not None
            and mesh.devices.size == len(jax.devices()),
            # the path-sliced multihost build carries no host item tables;
            # the redundant-itemization fallback does
            path_sliced=gb._itemized.item_tables[0] is None,
            mh_stats=getattr(gb._itemized, "mh_stats", None),
            node_hist=[int(x) for x in hists[CountType.NODE].coverage],
            bp_hist=[int(x) for x in hists[CountType.BP].coverage],
            paths_len_total=sorted(
                (str(k), v[0], v[1]) for k, v in gb.get_path_lens().items()
            ),
        )
        if mode == "exclude":
            res["edge_hist"] = [
                int(x) for x in hists[CountType.EDGE].coverage
            ]
    elif mode == "group":
        # ordered growth + similarity read only the membership matrix, so
        # the abacus_by_group requirement no longer forces the redundant
        # fallback: the path-sliced build runs and the group programs
        # consume the globally assembled M
        reqs = {
            Req.graph(gfa),
            Req.NODE,
            Req.HIST,
            Req.abacus_by_group(CountType.NODE),
        }
        gb.change_graph_state(
            GraphState(graph=gfa, name="mh", grouping=Grouping.sample()),
            reqs,
            nice=False,
        )
        ab = gb.get_abacus_by_group()
        mesh = item_mesh_of(ab.engine.M)
        og = ab.calc_growth(Threshold.absolute(1), Threshold.rel(0.0))
        inter, sizes = ab.similarity_matrix()
        res.update(
            m_sharded=mesh is not None
            and mesh.devices.size == len(jax.devices()),
            path_sliced=gb._itemized.item_tables[0] is None,
            node_hist=[
                int(x) for x in gb.get_hists()[CountType.NODE].coverage
            ],
            ordered=[float(x) for x in og],
            sim_trace=float(inter.trace()),
            sim_sum=float(inter.sum()),
        )
    elif mode in ("subset", "coordexclude"):
        # masked path-sliced build: the exact interval walker runs per
        # group range; exclude bitmaps / covered-bp intervals / paths_len
        # merge across processes (parallel.ingest.multihost_masked_abaci)
        reqs = {Req.graph(gfa), Req.NODE, Req.BP, Req.HIST, Req.PATH_LENS}
        state = GraphState(graph=gfa, name="mh", grouping=Grouping.sample())
        if mode == "subset":
            state.subset = sys.argv[4]
            if len(sys.argv) > 5:  # combined subset + exclude
                state.exclude = sys.argv[5]
        else:
            state.exclude = sys.argv[4]
        gb.change_graph_state(state, reqs, nice=False)
        hists = gb.get_hists()
        eng = gb.get_abacus_by_total(CountType.NODE).engine
        mesh = item_mesh_of(eng.M)
        res.update(
            m_sharded=mesh is not None
            and mesh.devices.size == len(jax.devices()),
            path_sliced=getattr(gb._itemized, "mh_table_local", False),
            mh_stats=getattr(gb._itemized, "mh_stats", None),
            node_hist=[int(x) for x in hists[CountType.NODE].coverage],
            bp_hist=[int(x) for x in hists[CountType.BP].coverage],
            paths_len_total=sorted(
                (str(k), v[0], v[1]) for k, v in gb.get_path_lens().items()
            ),
        )
    elif mode == "table":
        reqs = {
            Req.graph(gfa),
            Req.NODE,
            Req.abacus_by_group(CountType.NODE),
            Req.group_table(CountType.NODE),
        }
        gb.change_graph_state(
            GraphState(graph=gfa, name="mh", grouping=Grouping.sample()),
            reqs,
            nice=False,
        )
        ab = gb.get_abacus_by_group()
        res.update(
            path_sliced=getattr(gb._itemized, "mh_table_local", False),
            table=ab.to_tsv(False, gb.graph_aux),
        )
    else:
        raise SystemExit(f"unknown mode {mode}")
    with open(out_path, "w") as f:
        json.dump(res, f)
    print("worker done", flush=True)


if __name__ == "__main__":
    main()
