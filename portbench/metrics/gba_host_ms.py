"""The part of a global BA outside its solve: the call's wall time minus
the ``bundle_adjust`` span (the snapshot, the host-device copies, the
write-back and the culling), per traced solve."""


def read(ctx):
    g = ctx.get("gba")
    if not g or not g["spans"]:
        return None
    return 1e3 * (sum(g["walls"]) - sum(g["spans"])) / len(g["spans"])
