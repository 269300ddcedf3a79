"""sweep.survivor_pct: the share of pairs that the prescreen bound lets
through to the exact kernel (useful outcomes over attempts): 100 x (1 -
screened / pairs), from the sweep's "screened" count."""


def read(rec):
    screened, n = rec["stage"].get("screened"), rec.get("pairs")
    return 100.0 * (1.0 - screened / n) if screened is not None and n \
        else None
