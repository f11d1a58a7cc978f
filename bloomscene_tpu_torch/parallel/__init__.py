"""Parallel layer on ``torch.distributed``: the ('data', 'tile') mesh, the
tile-parallel render and step, the data-parallel trainer's collectives and
the ring render (the port of ``bloomscene_tpu/parallel``)."""
