"""HEVC host helpers the containers need (hvcC ⇄ Annex B)."""
