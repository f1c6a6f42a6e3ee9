"""HEVC in the port: the decoder, its conformance stream generator and
the host helpers the containers need (hvcC ⇄ Annex B)."""
