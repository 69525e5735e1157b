"""The dense LM substrate the CIM-in-the-loop trainer runs on."""
