"""read_wait_share.call: % of the measured window that the entry spent
waiting in next() on its input."""


def read(res, cell):
    t0, t1 = res["window"]
    return 100.0 * sum(res["spans"].within("read_wait", t0, t1)) / (t1 - t0)
