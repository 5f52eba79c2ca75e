"""Time to first token, 95th percentile (client layer): from a request's
send, which waits for the card's one prefill at a time, to its first token,
over the requests whose first token came inside the window."""
from portbench import harness


def read(r):
    ttft = [s.times[0] - s.t_send for s in r.win.served if s.times and r.win.inside(s.times[0])]
    return harness.nearest_rank(ttft, 95) * 1e3 if ttft else None
