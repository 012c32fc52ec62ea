"""Share of the lanes' iterations that served a request: the requests'
iterations over, summed over dispatches, the padded lanes times the
slowest lane's iterations (``SolveResult.iterations``,
``SolveServer.stats``)."""


def read(r):
    s = r.get("serve")
    if not s or not s["lane_slot_iters"]:
        return None
    return 100.0 * s["useful_iters"] / s["lane_slot_iters"]
