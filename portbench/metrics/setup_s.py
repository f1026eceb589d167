"""setup_s: from the run script's first statement to the first timed query:
imports, the card's start, kernel load (and build, in a checkout's first
run), the inputs, the system's build and the warm-up."""


def read(run):
    return run.setup_s
