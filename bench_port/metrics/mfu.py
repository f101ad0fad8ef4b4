"""The whole step's share of the card's dense bf16 peak: the operations of
the sequences the window completed (roofline.sequence_costs, a floor) over
the window's seconds."""


def read(ctx):
    peaks = ctx["peaks"]
    if peaks is None:
        return None
    tr, w = ctx["traffic"], ctx["window"]
    per_seq = ctx["roofline"].sequence_costs(tr["height"], tr["width"], ctx["config"], tr["n_frames"],
                                             tr["frame_chunk"], tr["pair_chunk"]).flops
    return per_seq * w["sequences"] / w["seconds"] / peaks["bf16"]
