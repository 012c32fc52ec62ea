"""Pattern analyses over the window (``PLAN_STATS["analyze"]``): 0 while
the plan made at set-up is reused."""


def read(r):
    return r["counters"]["plan"].get("analyze")
