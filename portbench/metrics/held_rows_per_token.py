"""The rows the held experts took, over the tokens routed through the
MoE layers (a layer each), in the traced calls: about top_k x held /
router (1.25 at 10 x 9 / 72) where routing is dropless and even;
nothing where the program has no such counters."""
from portbench import lm_phases


def read(run):
    c = lm_phases.counters(run)
    if c is None or not c.get("tokens_routed"):
        return None
    return c["held_rows"] / c["tokens_routed"]
