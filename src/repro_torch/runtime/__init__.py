"""Threaded-runtime support of the port: the lock-order sanitizer and
the fault-tolerance primitives the design service runs on."""
