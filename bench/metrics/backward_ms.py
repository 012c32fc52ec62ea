"""Mean time of ``backward()`` a step (the adjoint solve and the gradient's
way back to κ), the benchmark's synchronised span over the window."""


def read(r):
    spans = r["spans"].get("backward")
    return sum(spans) / len(spans) * 1e3 if spans else None
