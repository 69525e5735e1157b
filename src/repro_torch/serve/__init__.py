"""Serving layers of the port: the multi-tenant `DesignService` and the
LM decode engine (`engine.ServeEngine`)."""
