"""term_ms.bonded: device ms a step of the bonded terms (bonds, angles,
torsions and their row sum): the replayed CUDA-graph nodes that the
program's span ``omgf.force.bonded`` issued, innermost, when their block
was captured, summed over the traced MD window's replays and divided by its
steps (gfbench.spans.term_ms). None where the replays' operations do not
align one to one with their blocks' nodes."""

from gfbench import spans


def read(run):
    return spans.term_ms(run, "omgf.force.bonded")
