"""CUDA graphs captured inside the window (server layer): the difference of
``RegionServer.stats()["graphs"]["captures"]`` across it. Set-up captures
every graph the traffic needs, so anything here is a stall in the window."""


def read(r):
    opened, closed = r.win.captures
    return closed - opened
