"""caption_decode_ms: mean ms of ``CaptionPredictor.decode`` per call
in the traced run, timed by the benchmark with a synchronise on each side."""


def read(ctx):
    spans = ctx.spans.get("caption_decode")
    return 1e3 * sum(spans) / len(spans) if spans else None
