"""Share of the label slots a BN colour update gathers that hold a real
label of a real table: the program's counters
``pgm_bn_label_slots_total{kind=real}`` (sum of card_v * (1 + children_v)
over the lanes) over ``{kind=padded}`` (lanes * L * (1 + C)). Layer:
colour update.

In bn-munin-scale.offline, moves ``msample_s.penguin``."""


def read(ctx):
    c = ctx.get("counters") or {}
    real = c.get("pgm_bn_label_slots_total{kind=real}")
    padded = c.get("pgm_bn_label_slots_total{kind=padded}")
    if not real or not padded:
        return None
    return 100.0 * real / padded
