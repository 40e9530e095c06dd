"""Generators drawn from a run's seed: one stream shared by every rank
(what must be the same everywhere, such as a planted β) and one stream of
each rank's own (its rows). A seed may be any whole number up to a little
over 2**31, and larger."""

SHARED = 0


def generator(torch, device, seed, stream):
    """A ``torch.Generator`` on ``device`` for (``seed``, ``stream``)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 4099 + int(stream)) % (1 << 63))
    return g


def rank_stream(rank):
    return 1 + int(rank)
