"""embed_req_p95_ms (ms): the 95th percentile over every request of the
window of one request's latency, from the call into
``SpeakerEmbedder.embed`` to the embeddings on the host."""

import numpy as np


def read(cell, counts, trace):
    lat = counts.get("latency_ms")
    if counts.get("kind") != "embed" or not lat:
        return None
    return float(np.percentile(lat, 95))
