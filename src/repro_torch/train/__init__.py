"""Trainers of the port: the CIM-in-the-loop trainer (`acim_lm`) and the
fault-tolerant LM trainer (`trainer`)."""
