"""Traffic drivers, one module per kind of traffic, found by the ``driver``
key of a traffic file. Each module defines ``Driver(ctx)`` with
``prepare()`` (set-up: warm-up and inputs made before the window),
``measure()`` (the window) and
``close()``; ``measure`` returns a dict with the end-to-end metrics
(``e2e``), ``attempted``, ``failed``, the sampled ``answers`` to judge, the
window's counters (``counters``), the engine calls it drove (``calls``),
the reduced trace (``trace``, traced runs only), ``window_s`` and, where
the configuration names a question encoder, the program's own rows of the
questions the comparison and the work count read (``query_rows``:
{"triple": {question: row}, "passage": {...}})."""
