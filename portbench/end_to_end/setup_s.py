"""Seconds from process start to the first timed statement: kernel
build or load, generation, load, connect, warm-up."""


def read(r):
    return r.setup_s
