"""Open loop: requests arrive at the times of a Poisson process of the
mix's ``rate_per_s`` a second, drawn from the run's seed, whatever the
system does. One client sends each once it has arrived and the one before
it has returned (the engine serves one call at a time), so a request's
latency runs from its arrival to its tables on the host, its wait in the
queue included. Requests still queued at the window's close are not
sent."""

import time

import numpy as np


def window(requests, order) -> None:
    rate = float(requests.traffic.params["rate_per_s"])
    rng = np.random.default_rng([requests.seed, 3])
    arrival = requests.start
    while True:
        arrival += rng.exponential(1.0 / rate)
        if max(arrival, time.perf_counter()) >= requests.deadline:
            return
        wait = arrival - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        requests.send(next(order), since=arrival)
