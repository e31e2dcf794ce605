"""Mean host ms to enqueue one model evaluation over the window: the
benchmark's host clock around the model it hands to GaussianDiffusion
(the card not waited for), summed over every evaluation of the window
and divided by their count."""


def read(rec):
    spans = rec.get("dispatch_s")
    return 1e3 * sum(spans) / len(spans) if spans else None
