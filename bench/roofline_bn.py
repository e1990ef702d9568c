"""The yardstick of a Bayesian-network cell: the least time one colour
update needs on the H100, counted from the network's real cardinalities
and children, never from the program's padded label count ``L`` or child
count ``C``, so it holds whatever layout a kernel takes.

For a colour class of nodes ``V`` over ``chains`` chains:

* bytes: the states of the class's Markov blanket (the union over ``V``
  of parents, children and the children's other parents) read once and
  the class's states written once, a byte a state (a uint8 holds up to
  256 states); the log-CPT tables the class's conditionals read (each
  node's own and its children's, each table once) read once, float32;
* operations: each chain's real label slots, ``sum_v card_v * (1 +
  children_v)``, one add each.  The walk's column sums are left out, so
  the count stays a lower bound.

The sample stage alone (the fused kernel's work) reads each lane's
``card_v`` float32 log-weights and writes its state, and takes one
operation (the exp) a real label.  The least time is the larger of bytes
over the memory bandwidth and operations over the float32 rate of the
CUDA cores (``bench/roofline.py``'s peaks).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from bench.bn_task import children
from bench.roofline import FLOAT_BYTES, LABEL_BYTES, least_time_s


class Counts(NamedTuple):
    """What one colour update of one chain reads, writes and computes."""
    states_read: int
    states_written: int
    table_entries: int      # log-CPT floats read (for all chains at once)
    slots: int              # label slots summed
    labels: int             # labels of the lanes sampled


def colour_counts(card, parents, nodes) -> Counts:
    """The real counts of the colour class ``nodes``."""
    kids = children(parents)
    size = [int(card[v] * np.prod([card[p] for p in parents[v]]))
            for v in range(len(card))]
    blanket, tables = set(), set()
    for v in nodes:
        blanket.update(parents[v])
        for c in kids[v]:
            blanket.add(c)
            blanket.update(parents[c])
        tables.add(v)
        tables.update(kids[v])
    blanket.difference_update(nodes)
    return Counts(
        states_read=len(blanket), states_written=len(nodes),
        table_entries=sum(size[t] for t in tables),
        slots=sum(card[v] * (1 + len(kids[v])) for v in nodes),
        labels=sum(card[v] for v in nodes))


def padded_counts(g: int, L: int, C: int, P: int) -> Counts:
    """What the program's padded gather touches for a class of ``g``
    nodes: each node's ``P`` parent states and each of its ``C`` child
    slots' state and ``P`` other parents; ``L`` floats of its own row and
    of each child slot; ``L`` labels a lane."""
    return Counts(states_read=g * (P + C * (1 + P)), states_written=g,
                  table_entries=g * L * (1 + C), slots=g * L * (1 + C),
                  labels=g * L)


def update_least_s(n: Counts, chains: int) -> float:
    nbytes = (chains * (n.states_read + n.states_written) * LABEL_BYTES
              + n.table_entries * FLOAT_BYTES)
    return least_time_s(nbytes, chains * n.slots)


def sample_least_s(n: Counts, chains: int) -> float:
    lanes = chains * n.states_written
    nbytes = chains * n.labels * FLOAT_BYTES + lanes * LABEL_BYTES
    return least_time_s(nbytes, chains * n.labels)


class Yardstick:
    """Least times of a network's colour updates over ``chains`` chains:
    ``sweep_s`` sums every class's update, ``sample_sweep_s`` every
    class's sample stage."""

    def __init__(self, net, colours, chains: int):
        self.counts = [colour_counts(net.card, net.parents, cls)
                       for cls in colours]
        self.sweep_s = sum(update_least_s(n, chains) for n in self.counts)
        self.sample_sweep_s = sum(sample_least_s(n, chains)
                                  for n in self.counts)
