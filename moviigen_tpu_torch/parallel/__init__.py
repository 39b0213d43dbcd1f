"""Sequence parallelism and sharded parameters: the counterpart of
``moviigen_tpu/parallel``. ``comm`` holds the collectives over the mesh
axes (``DistComm`` over ``torch.distributed``, ``ThreadComm`` over threads
of one process), ``distributed`` and ``mesh`` build them, ``ulysses`` and
``ring`` run the DiT's self-attention across ranks, ``sharding`` keeps the
weights as shards gathered per block."""
