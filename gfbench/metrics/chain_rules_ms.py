"""chain_rules_ms: host ms a traced conformation inside the program's
``omgf.gridgen.chain_rules`` spans (the cap's and the inverse power's
chain rules over the raw 27-derivative sums), on the profiler's clock."""

from gfbench import spans


def read(run):
    return spans.per_receptor_host_ms(run, "omgf.gridgen.chain_rules")
