"""Keyframes spawned a registered frame, as the stream counts them, over
every request of the window."""


def read(ctx):
    frames = sum(r["work"] for r in ctx.records)
    if not frames or any("spawns" not in r for r in ctx.records):
        return None
    return sum(int(r["spawns"]) for r in ctx.records) / frames
