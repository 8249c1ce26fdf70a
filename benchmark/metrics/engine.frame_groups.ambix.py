"""The frame-block tap groups (engine/batch.py frame_tap_groups: the shared
STFT's and the modal cloud's) a call's steps ran: the program's counter
frame_groups in each call's phases, mean over the traced calls of
ambix64.third. A program without the counter reads None."""


def read(ctx):
    counts = [ph["frame_groups"] for ph in map(ctx.entry.phases, ctx.records) if "frame_groups" in ph]
    return sum(counts) / len(counts) if counts else None
