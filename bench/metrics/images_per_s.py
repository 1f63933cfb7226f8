"""Images completed per second: every image that finished after the
window's first completion round, over the time from that round to the
window's last completion round."""


def read(run):
    lo, hi = run.window
    rounds = sorted(c for c in run.completions.values() if lo <= c[0] <= hi)
    if len(rounds) < 2 or rounds[-1][0] <= rounds[0][0]:
        return None
    return sum(n for _, n in rounds[1:]) / (rounds[-1][0] - rounds[0][0])
