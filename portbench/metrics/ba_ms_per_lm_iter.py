"""The ``bundle_adjust`` span of a traced global BA over its LM iterations
(``solvers/local_ba.py``, the PCG Schur solve)."""


def read(ctx):
    g = ctx.get("gba")
    if not g or not g["spans"]:
        return None
    return 1e3 * sum(g["spans"]) / (len(g["spans"]) * g["n_iters"])
