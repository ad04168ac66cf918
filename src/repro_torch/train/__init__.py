"""Training of the port's LMs (every family): AdamW
(``optimizer``), the training step with rematerialisation and
microbatching (``train_step``), checkpoints interchangeable with the
reference's (``checkpoint``) and the fault-tolerant loop (``loop.fit``).

The counterpart of ``repro.train``. One device; a mesh raises
NotImplementedError (ROADMAP §1 item 7).
"""
