"""Read alignment: seed lookup, diagonal vote, banded extension."""
