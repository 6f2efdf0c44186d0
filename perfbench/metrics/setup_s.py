"""Process start until the server is warm and the load generator has made
its uploads and had its warm-up requests answered."""


def read(run):
    return run.setup_s
