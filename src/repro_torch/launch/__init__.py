"""Launchers of the port: the LM step makers (prefill and decode,
:mod:`.steps`) and the Study-service front end (:mod:`.serve`)."""
