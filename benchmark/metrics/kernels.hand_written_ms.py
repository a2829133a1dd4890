"""Device ms per step of the hand-written kernels (the benchmark's frozen
`HAND_WRITTEN` names)."""


def read(rec):
    t = rec.trace
    if not t or not t["steps"]:
        return None
    hand = [r["us"] for r in t["rows"].values() if r["category"] == "hand-written"]
    return sum(hand) / t["steps"] / 1e3 if hand else None
