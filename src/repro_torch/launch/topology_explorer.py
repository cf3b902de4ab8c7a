"""Explore slice topologies through the port's cluster API: geometries,
twisting, bisection, collective costs, goodput, and the autotopo search.

    PYTHONPATH=src python -m repro_torch.launch.topology_explorer --chips 512
    PYTHONPATH=src python -m repro_torch.launch.topology_explorer \
        --chips 128 --search [--device cpu]

The twin of ``examples/topology_explorer.py`` through
``repro_torch.cluster``: each geometry of ``--chips`` chips is allocated on
the machine (its OCS port accounting runs), probed through the slice's
bound cost model and freed; then the Figure-4 goodput at three host
availabilities and, with ``--search``, the autotopo search for a 70B LLM
profile.  Its output equals the example's character for character.  All
of it is host analytics over the copied ``repro_torch.core``: the slices
carry ``--device`` (the card by default), and no tensor is made on it.
"""
import argparse

from repro_torch.cluster import Supercomputer
from repro_torch.core.autotopo import ModelProfile
from repro_torch.core.topology import is_twistable


def explore(chips: int, search: bool = False, device="cuda") -> Supercomputer:
    """Print the example's report for ``chips`` chips on a fresh machine
    whose slices compute on ``device``; returns the machine."""
    sc = Supercomputer(device=device)
    print(f"geometries for {chips} chips "
          f"(slices are 4i x 4j x 4k, paper §2.5):")
    print(f"{'geometry':>12s} {'twist':>6s} {'bisec':>6s} {'diam':>5s} "
          f"{'AR(1GiB)':>9s} {'A2A(1GiB)':>10s}")
    for dims in sc.geometries(chips):
        for tw in ([False, True] if is_twistable(dims) else [False]):
            if tw and dims[0] * dims[1] * dims[2] > 1024:
                continue
            with sc.allocate(dims, twisted=tw) as sl:
                topo = sl.topology
                ar = sl.cost.all_reduce(2 ** 30) * 1e3
                a2a = (sl.cost.all_to_all(2 ** 30) * 1e3
                       if sl.num_chips <= 512 else float("nan"))
                diam, _ = (topo.diameter_and_avg_hops()
                           if sl.num_chips <= 512 else (-1, 0))
                print(f"{sl.describe():>12s} {str(tw):>6s} "
                      f"{topo.bisection_links():>6d} {diam:>5d} "
                      f"{ar:>8.1f}m {a2a:>9.1f}m")

    print(f"\ngoodput at this slice size (Fig 4):")
    for av in (0.99, 0.995, 0.999):
        g_ocs = sc.expected_goodput(chips, av, mode="ocs", trials=1000)
        g_static = sc.expected_goodput(chips, av, mode="static", trials=200)
        print(f"  availability {av}: OCS {g_ocs:.2f}  static {g_static:.2f}")

    if search:
        prof = ModelProfile("explorer-llm", params=70e9, layers=80,
                            d_model=8192, seq_len=2048, global_batch=32)
        print("\nautotopo search (Table 3):")
        with sc.allocate(chips) as sl:
            print(f"  holding {sl.describe()}; best on THIS slice: "
                  f"{sl.dryrun(prof).spec.label()}")
            for ev in sl.autotopo(prof, top_k=5):
                print(f"  {ev.geometry} {ev.spec.label()}: "
                      f"{ev.step_time * 1e3:.1f} ms/step "
                      f"(compute {ev.terms['compute'] * 1e3:.1f}m, "
                      f"tp {ev.terms['tp'] * 1e3:.1f}m, "
                      f"dp {ev.terms['dp'] * 1e3:.1f}m)")
    return sc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--chips", type=int, default=512)
    ap.add_argument("--search", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return explore(args.chips, args.search, args.device)


if __name__ == "__main__":
    main()
