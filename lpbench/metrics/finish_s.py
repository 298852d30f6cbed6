"""finish_s: the seconds of the span "finish" in the traced run's profiled call
(span_tree.py): the unscale, the download and the gather of the solution by the
maps, after the loop's last sync."""

from lpbench import span_tree


def read(run):
    return span_tree.seconds(run, "finish")
