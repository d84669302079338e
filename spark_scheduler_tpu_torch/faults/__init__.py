"""Fault-tolerance pieces the extender core needs: the exception taxonomy
(`errors`) and the retry ladder (`retry`). The injector and the
degraded-mode controller are not ported yet."""
