"""Distributed incubating APIs."""
