"""The eval forward's operations (counted on the reference) times the images
a second of the window, over the card's dense peak in the cell's dtype."""

from benchmark import peaks


def read(run):
    per_image = run.flops / run.traffic["batch"]
    return 100.0 * per_image * run.rate / peaks.BY_DTYPE[run.traffic["dtype"]]
