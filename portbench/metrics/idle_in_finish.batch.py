"""idle_in_finish: the part of the profiled segment in which no kernel ran
on the card while the host was in the program's ``collect.finish`` span
(the host finish of a batch), in % of the segment: the exact overlap of
the segment's idle gaps with those spans."""
from portbench import spans


def read(ctx):
    return spans.idle_in(ctx, "collect.finish")
