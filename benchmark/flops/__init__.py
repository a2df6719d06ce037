"""Operations and bytes of the work each configuration needs, from its shapes."""
