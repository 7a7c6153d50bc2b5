"""burnin_s.train: the model's burn-in phase (``phase_seconds["burn_in"]``,
host clock ending in a synchronize), the mean over the window's trains."""


def read(run):
    times = run.counts.get("burnin_s")
    return sum(times) / len(times) if times else None
