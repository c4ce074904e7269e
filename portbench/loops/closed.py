"""Closed loop: one client, each request sent once the one before it has
returned, for the whole window; a request's latency is its call's."""

import time


def window(requests, order) -> None:
    while time.perf_counter() < requests.deadline:
        requests.send(next(order))
