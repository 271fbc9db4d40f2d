"""A train step's operations (three times the reference's training forward and
loss) times the images a second of the window, over the card's dense peak in
the cell's dtype (float32 with TF32 off: the rate outside the tensor cores)."""

from benchmark import peaks


def read(run):
    per_image = run.flops / run.traffic["batch"]
    return 100.0 * per_image * run.rate / peaks.BY_DTYPE[run.traffic["dtype"]]
