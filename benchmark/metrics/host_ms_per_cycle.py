"""Host ms a cycle of the robot's node (layer: host node): the median over
the untraced stretch's cycles of the program's ``node.tick`` span less its
replay's span on the card (``graph.end`` - ``graph.start``), both on the
program's host clock (``benchmark/spans.py``): measurements in, the replay
call, the output copy and the decoding.  None without the program's
records or node cycles."""
import statistics

from benchmark import spans


def read(ctx, suffix):
    recs = spans.program_records()
    by_id = {s.id: s for s in recs.spans} if recs is not None else {}
    host = []
    for r in spans.window(recs, ctx):
        node = by_id.get(r.span.parent)
        while node is not None and node.name != "node.tick":
            node = by_id.get(node.parent)
        device = r.part("graph")
        if node is not None and device is not None:
            host.append(node.end - node.start - device)
    return 1e-6 * statistics.median(host) if host else None
