"""Serving layers of the port: the multi-tenant `DesignService`."""
