"""Count where the JAX package's jitted degree-bucket sum and the port's
left fold part ways, on one colour update of a large sparse spin glass.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/sparse_sum_gap.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/sparse_sum_gap.py \
        --spins 65536 --chains 8 --colors 1

Inside ``jit`` XLA's CPU backend sums a D > 8 bucket's D table rows in
an order of its own (``repro.pgm.sparse_compile._plan_energies``); the
port folds left at every degree.  On tables that do not sum exactly the
candidate energies can then differ in their last bits, and a KY weight
by one.  This script builds ``random_sparse_ising(spins)`` in both
packages, draws the same states (``init_fg_states``, key 0), and for the
first ``--colors`` colours compares the reference's jitted colour-update
tail — ``_plan_energies`` then ``ky_weights`` in one ``jit``, as its round
runner runs them — with the port's ``_plan_energies`` and ``ky_weights``
on the CPU.  It prints the bucket widths, the counts of differing
energies and weights, and the largest weight difference; it exits 1 if
a weight differs by more than one.

A measurement for the repository's records (ROADMAP Queue 3): it runs
both packages, so it is not part of the port and needs JAX installed.
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spins", type=int, default=65536)
    ap.add_argument("--chains", type=int, default=8)
    ap.add_argument("--colors", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "src"))

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.pgm import compile as j_comp
    from repro.pgm import networks as j_net
    from repro.pgm import sparse_compile as j_sc
    from repro_torch.core import rng as t_rng
    from repro_torch.pgm import compile as t_comp
    from repro_torch.pgm import networks as t_net
    from repro_torch.pgm import sparse_compile as t_sc

    t0 = time.perf_counter()
    jp = j_sc.compile_factor_graph(j_net.random_sparse_ising(args.spins))
    tp = t_sc.compile_factor_graph(t_net.random_sparse_ising(args.spins))
    xj = j_sc.init_fg_states(jax.random.PRNGKey(0), jp, args.chains)
    xt = t_sc.init_fg_states(t_rng.PRNGKey(0), tp, args.chains,
                             device="cpu")
    if not np.array_equal(np.asarray(xj), xt.numpy()):
        raise SystemExit("initial states differ between the packages")
    unary = jnp.asarray(jp.unary)
    tables = jnp.asarray(jp.tables).reshape(-1)
    card = jnp.asarray(jp.fg.card, jnp.int32)
    ops = t_sc._Operands(tp, "cpu")
    e_diff = e_all = w_diff = w_all = w_max = 0
    widths = set()
    for jplan, tplan in list(zip(jp.plans, ops.plans))[:args.colors]:
        widths |= {int(b.nbr.shape[1]) for b in jplan.buckets}

        @jax.jit
        def tail(x, p=jplan):
            e = j_sc._plan_energies(x, p, unary, tables, jp.max_card)
            return e, j_comp.ky_weights(-e, card[jnp.asarray(p.nodes)],
                                        jp.k, True)

        ej, wj = (np.asarray(a) for a in tail(xj))
        et = t_sc._plan_energies(xt, tplan, ops.unary, ops.tables_flat,
                                 tp.max_card)
        wt = t_comp.ky_weights(-et, ops.card[tplan.nodes], tp.k,
                               True).numpy()
        et = et.numpy()
        e_diff += int((ej != et).sum())
        e_all += ej.size
        w_diff += int((wj != wt).sum())
        w_all += wj.size
        w_max = max(w_max, int(np.abs(wj.astype(np.int64) - wt).max()))
    print(f"random_sparse_ising({args.spins}), {args.chains} chains, "
          f"{min(args.colors, len(jp.plans))} of {len(jp.plans)} colours, "
          f"bucket widths {sorted(widths)}: energies differ {e_diff}/{e_all}, "
          f"weights differ {w_diff}/{w_all} (largest difference {w_max}); "
          f"{time.perf_counter() - t0:.1f} s on the CPU")
    del torch
    return 0 if w_max <= 1 else 1


if __name__ == "__main__":
    sys.exit(main())
