"""Durable state: device-layout snapshots of the live replica."""
