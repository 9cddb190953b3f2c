"""WeSpeaker ResNet34's trunk against its roofline: the least seconds of a
hop's 36 convolutions (``portbench.work.resnet34.trunk_least_s``: each the
larger of its products at the stated precision's peak and its input read,
output written and weights read once over HBM) over the mean device seconds
of the trunk a hop (``trunk_ms``, which also holds the glue between the
convolutions), in percent; None where the embedding is no ResNet34 or the
port recorded no trunk event."""

from portbench.metrics import _trunk
from portbench.work.resnet34 import trunk_least_s


def read(r):
    emb = r.config["embedding"]
    ms = _trunk.trunk_ms(r)
    if emb["reference"] != "resnet34" or not ms or sum(ms) <= 0:
        return None
    least = trunk_least_s(emb["args"], r.config["precision_of_parts"], r.batch)
    return 100.0 * least * len(ms) / (sum(ms) * 1e-3)
