"""Launchers of the port: the LM step makers (prefill and decode,
:mod:`.steps`), the Study-service front end (:mod:`.serve`), the LM train
driver (:mod:`.train`), and multi-rank studies (:mod:`.distributed`,
with its meshes in :mod:`.mesh`)."""
