"""Training of the port's LMs (every family): AdamW
(``optimizer``), the training step with rematerialisation and
microbatching (``train_step``), checkpoints interchangeable with the
reference's (``checkpoint``) and the fault-tolerant loop (``loop.fit``).

The counterpart of ``repro.train``. One device; a mesh raises
NotImplementedError: the reference's step shards through
``sharding.make_constrain``, which its ``dist/sharding.py`` does not
define, so neither package trains on a mesh (ROADMAP §3).
"""
