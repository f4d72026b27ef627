#!/usr/bin/env python3
"""Find, on the card, the order in which ``torch.matmul``'s batched float32
matvec (cuBLAS gemv) sums at each shape of ``ops.linalg.MATVEC_ORDERS``,
for every launch size c = 1 .. 65535 (cuBLAS cuts a batch into launches of
at most 65535 lanes and picks a kernel by the launch's size), and compare
it with the table the matvec kernel follows::

    python3 tools/torch_matvec_orders.py            # every c, ~1 min
    python3 tools/torch_matvec_orders.py --cmax 4096

Pair probes: ones, with +2^30 and -2^30 at terms i and j of a sum.  The two
cancel where their subtrees meet, and the ones added into either side
before that are lost, so the result is K less the size of the smallest
subtree that holds both terms.  One call holds every pair (i, j) in some
(lane, row) once c is large enough; each of the kernel's six orders
(``csrc/matvec.cu`` ``Order``) predicts every such size, and the order
whose sizes all match is cuBLAS's for that c.  Prints the runs of c by
order as ``MATVEC_ORDERS`` writes them, and exits 1 where they differ
from the table (or where no order matches: then a new order is needed).
"""

import argparse
import itertools
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from lcqpow_tpu_torch.ops import linalg  # noqa: E402

BIG = 2.0 ** 30


def chains(order, K):
    """(chains of term indices, add tree over the chains' sums) of an
    order, as ``csrc/matvec.cu`` spells it."""
    h = K // 2
    quads = [list(range(i, min(i + 4, K))) for i in range(0, K, 4)]
    return {
        linalg.HALVES: ([list(range(h)), list(range(h, K))], (0, 1)),
        linalg.EVEN_ODD: ([list(range(0, K, 2)), list(range(1, K, 2))],
                          (0, 1)),
        linalg.MOD4: ([list(range(r, K, 4)) for r in range(4)],
                      ((0, 2), (1, 3))),
        linalg.QUADS_0213: (quads, ((0, 2), (1, 3))),
        linalg.QUADS_SEQ: (quads, (((0, 1), 2), 3)),
        linalg.PAIRS8: ([[2 * i, 2 * i + 1] for i in range(K // 2)],
                        (((0, 4), (2, 6)), ((1, 5), 3))),
    }[order]


def lca_sizes(order, K):
    """Size of the smallest subtree holding terms i < j, for each pair."""
    parts, tree = chains(order, K)

    def expand(node):
        if isinstance(node, int):
            t = parts[node][0]
            for k in parts[node][1:]:
                t = (t, k)
            return t
        return expand(node[0]), expand(node[1])

    def leaves(t):
        return [t] if isinstance(t, int) else leaves(t[0]) + leaves(t[1])
    size = {}

    def walk(t):
        if isinstance(t, int):
            return
        a, b = leaves(t[0]), leaves(t[1])
        for i in a:
            for j in b:
                size[min(i, j), max(i, j)] = len(a) + len(b)
        walk(t[0])
        walk(t[1])
    walk(expand(tree))
    return [size[p] for p in itertools.combinations(range(K), 2)]


def probes(m, n, trans, c, offset, device):
    """A (c, m, n), the ones vector and each (lane, row)'s pair index."""
    K, R = (m, n) if trans else (n, m)
    pairs = list(itertools.combinations(range(K), 2))
    slot = (torch.arange(c, device=device)[:, None] * R
            + torch.arange(R, device=device)[None, :] + offset) % len(pairs)
    first = torch.tensor([p[0] for p in pairs], device=device)[slot]
    second = torch.tensor([p[1] for p in pairs], device=device)[slot]
    At = torch.ones(c, R, K, device=device)
    At.scatter_(2, first[..., None], BIG)
    At.scatter_(2, second[..., None], -BIG)
    A = At.mT.contiguous() if trans else At
    return A, torch.ones(c, K, device=device), slot


def sweep(m, n, trans, cmax, device):
    """The order cuBLAS sums in at each c (None where none matches)."""
    K, R = (m, n) if trans else (n, m)
    P = K * (K - 1) // 2
    orders = sorted({o for _, o in linalg.MATVEC_ORDERS[m, n, trans]}
                    | {linalg.HALVES, linalg.EVEN_ODD, linalg.MOD4}
                    | ({linalg.QUADS_0213, linalg.QUADS_SEQ, linalg.PAIRS8}
                       if K == 14 else set()))
    sizes = torch.tensor([lca_sizes(o, K) for o in orders], device=device,
                         dtype=torch.float32)
    plain = linalg.mtv_plain if trans else linalg.mv_plain
    A_all, ones, slot_all = probes(m, n, trans, cmax, 0, device)
    match = torch.zeros(cmax + 1, len(orders), dtype=torch.bool,
                        device=device)
    for c in range(1, cmax + 1):
        ok = torch.ones(len(orders), dtype=torch.bool, device=device)
        if c * R >= P:
            calls = [(A_all[:c], ones[:c], slot_all[:c])]
        else:
            calls = [probes(m, n, trans, c, off, device)
                     for off in range(0, P, c * R)]
        for A, v, slot in calls:
            got = K - plain(A, v)
            ok &= (got.unsqueeze(0) == sizes[:, slot]).flatten(1).all(1)
        match[c] = ok
    found = []
    for row in match[1:].cpu().tolist():
        hits = [o for o, hit in zip(orders, row) if hit]
        found.append(hits[0] if len(hits) == 1 else None)
    return found


def runs(found):
    out = []
    for c, order in enumerate(found, start=1):
        if not out or out[-1][1] != order:
            out.append((c, order))
    return tuple(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cmax", type=int, default=linalg.CUBLAS_LAUNCH)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    card = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"{card} torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    names = {v: k for k, v in vars(linalg).items()
             if k in ("HALVES", "EVEN_ODD", "MOD4", "QUADS_0213",
                      "QUADS_SEQ", "PAIRS8")}
    bad = 0
    for (m, n, trans), table in linalg.MATVEC_ORDERS.items():
        got = runs(sweep(m, n, trans, args.cmax, device))
        want = tuple((c, o) for c, o in table if c <= args.cmax)
        same = got == want
        bad += not same
        shown = ", ".join(f"({c}, {names.get(o, 'none')})" for c, o in got)
        print(f"({m}, {n}, {trans}): {shown}  "
              f"{'as in MATVEC_ORDERS' if same else 'DIFFERS from MATVEC_ORDERS'}",
              flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
