"""term_ms.integrate: device ms a step of the Langevin step's own
operations and the block's carry write-back (the step's span, less the
force terms nested in it): the replayed CUDA-graph nodes that the program's
span ``omgf.step.integrate`` issued, innermost, when their block was
captured, summed over the traced MD window's replays and divided by its
steps (gfbench.spans.term_ms). None where the replays' operations do not
align one to one with their blocks' nodes."""

from gfbench import spans


def read(run):
    return spans.term_ms(run, "omgf.step.integrate")
