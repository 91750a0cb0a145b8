"""Miss pulls a sample over the cost steps (the cache protocol's
``miss_pull`` count, summed over workers)."""


def read(run):
    if not run.counts:
        return None
    pulls = sum(int(c["miss_pull"].sum()) for c in run.counts.values())
    return pulls / (len(run.counts) * run.k)
