"""Share of the expert routes that capacity dropped in the traced steps:
100 x the program's counter ``moe.routes_dropped`` over ``moe.routes``
(``moe_ffn``'s ``keep``, counted in the forward, not in remat's replay).
A dropped route's token gets nothing from that expert; each one also
indexes the gather's trash row."""
UNIT = "%"
LAYER = "model: experts"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(ctx):
    try:
        from repro_torch import obs
    except ImportError:          # a program without the recorder
        return None
    counters = obs.records().counters
    routes = counters.get("moe.routes", 0)
    if not routes:
        return None
    return 100.0 * counters.get("moe.routes_dropped", 0) / routes
